// Whole-scan LTI partitioned convolution on Hopper (sm_90a).
//
// Replaces the TPU kernel opencl_fft_tpu/ops/pallas/streamstep.py:_stream_kernel
// (wrapper stream_steps_fused). For every input block t it computes the same
// thing: forward rFFT of the zero-padded block as one matmul against wfwd, a
// one-frame slide of the spectral window, the frequency-delay-line complex MAC
// against the reversed IR spectra (bin 0 componentwise, scaled by b0), one
// matmul against wpost (unpack + inverse DFT + deinterleave), overlap-add and
// division by pts.
//
// What bounds it on the card. At the headline shape (pts = bins = 512,
// nparts = 256, nb = 1880 blocks) the forward product is nb * pts * 2b * 2
// ~ 2.0 GFLOP, the inverse product nb * 2b * 2b * 2 ~ 3.9 GFLOP and the MAC
// nb * nparts * bins * 8 ~ 2.0 GFLOP, all float32 (the JAX tables run at
// Precision.HIGHEST, so no TF32). The data is a few MB: the tables are 6 MB,
// the frame timeline 8.7 MB, the MAC output 7.7 MB, all L2-resident. So the
// scan is bound by FP32 FMA issue, not by memory.
//
// What the design does about it. The TPU kernel walks the blocks as a
// sequential grid with the window, h and the tables resident in VMEM; a
// Hopper block has 227 KB of shared memory and blocks run in no order. But
// every input block of a scan is known up front, so the sequence dissolves:
//   1. fwd_gemm_kernel: F = blocks (nb, pts) @ wfwd (pts, 2b) lands in rows
//      [nparts, nparts+nb) of a frame timeline whose rows [0, nparts) are the
//      initial window w0 (row q = frame wp0+q). Window t is rows
//      [t+1, t+1+nparts).
//   2. mac_kernel: acc[t, k] = sum_q T[t+1+q, k] * h[q, k], one thread per
//      bin k and MAC_TT consecutive blocks, the TT window rows held in
//      registers and slid by one row per q, so each timeline and h element
//      is loaded once per TT outputs. Bin 0 takes its own loop.
//   3. post_ola_kernel: the overlap-add is folded into the second product.
//      acc is stored with a zero row before and after it (aext), so the
//      (nb+1, 4b) matrix whose row t is [acc[t-1] | acc[t]] is aext read
//      with row stride 2b. Against [wpost[:, b:] ; wpost[:, :b]] its row t
//      is y[t-1, b:] + y[t, :b]: rows t < nb are the outputs (plus the
//      carried tail at t = 0, then / pts), row nb is the final tail.
// Both products are one shared-memory tiled FP32 FMA SGEMM (64x64 tiles,
// 4x4 outputs per thread). The final window is timeline rows [nb, nb+nparts).
// wgmma/TMA products and a persistent variant for small nb are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);   // 256

constexpr int MAC_TT = 8;          // output blocks per MAC thread
constexpr int MAC_THREADS = 128;   // bins per MAC block

inline int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// acc = the (BM x BN) tile at (row0, col0) of A (M x K, row stride lda) @
// B (K x N, row stride ldb); thread (ty, tx) holds rows ty*TM.., cols tx*TN..
__device__ __forceinline__ void gemm_tile(int M, int N, int K,
                                          const float* __restrict__ A, int lda,
                                          const float* __restrict__ B, int ldb,
                                          int row0, int col0,
                                          float (&acc)[TM][TN]) {
    __shared__ __align__(16) float As[BK][BM + 4];   // k-major: As[k][m]
    __shared__ __align__(16) float Bs[BK][BN + 4];
    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int i = tid; i < BM * BK; i += GEMM_THREADS) {
            const int m = i / BK, k = i % BK;
            const int gm = row0 + m, gk = k0 + k;
            As[k][m] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * lda + gk] : 0.f;
        }
        for (int i = tid; i < BK * BN; i += GEMM_THREADS) {
            const int k = i / BN, n = i % BN;
            const int gk = k0 + k, gn = col0 + n;
            Bs[k][n] = (gk < K && gn < N) ? B[static_cast<size_t>(gk) * ldb + gn] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
            const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
            const float av[TM] = {a.x, a.y, a.z, a.w};
            const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
}

// frames (nb, 2b) = blocks (nb, pts) @ wfwd (pts, 2b)
__global__ void __launch_bounds__(GEMM_THREADS)
fwd_gemm_kernel(int nb, int pts, int b2, const float* __restrict__ blocks,
                const float* __restrict__ wfwd, float* __restrict__ frames) {
    const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
    float acc[TM][TN];
    gemm_tile(nb, b2, pts, blocks, pts, wfwd, b2, row0, col0, acc);
    const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty * TM + i;
        if (r >= nb) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = col0 + tx * TN + j;
            if (c < b2) frames[static_cast<size_t>(r) * b2 + c] = acc[i][j];
        }
    }
}

template <bool DC>
__device__ __forceinline__ void mac_rows(int nb, int nparts, int bins, int k, int t0,
                                         const float* __restrict__ tl,
                                         const float* __restrict__ hr,
                                         const float* __restrict__ hi,
                                         float b0, float* __restrict__ aext) {
    const size_t b2 = 2 * static_cast<size_t>(bins);
    const int nrows = nparts + nb;
    float xr[MAC_TT], xi[MAC_TT], ar[MAC_TT], ai[MAC_TT];
    // window of block t0+j at partition q is timeline row t0+j+1+q
#pragma unroll
    for (int j = 0; j < MAC_TT; ++j) {
        const int r = t0 + 1 + j;
        xr[j] = r < nrows ? tl[r * b2 + k] : 0.f;
        xi[j] = r < nrows ? tl[r * b2 + bins + k] : 0.f;
        ar[j] = 0.f;
        ai[j] = 0.f;
    }
    for (int q = 0; q < nparts; ++q) {
        const float h_r = hr[static_cast<size_t>(q) * bins + k];
        const float h_i = hi[static_cast<size_t>(q) * bins + k];
#pragma unroll
        for (int j = 0; j < MAC_TT; ++j) {
            if (DC) {            // packed (DC/2, Nyq/2) bin: componentwise
                ar[j] += xr[j] * h_r;
                ai[j] += xi[j] * h_i;
            } else {
                ar[j] += xr[j] * h_r - xi[j] * h_i;
                ai[j] += xr[j] * h_i + xi[j] * h_r;
            }
        }
#pragma unroll
        for (int j = 0; j < MAC_TT - 1; ++j) {
            xr[j] = xr[j + 1];
            xi[j] = xi[j + 1];
        }
        const int r = t0 + 1 + q + MAC_TT;
        xr[MAC_TT - 1] = r < nrows ? tl[r * b2 + k] : 0.f;
        xi[MAC_TT - 1] = r < nrows ? tl[r * b2 + bins + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < MAC_TT; ++j) {
        const int t = t0 + j;
        if (t >= nb) break;
        float* row = aext + (t + 1) * b2;   // aext row t+1 holds acc[t]
        row[k] = DC ? b0 * ar[j] : ar[j];
        row[bins + k] = DC ? b0 * ai[j] : ai[j];
    }
}

// aext[t+1] = [acc_re[t] | acc_im[t]] for t < nb
__global__ void __launch_bounds__(MAC_THREADS)
mac_kernel(int nb, int nparts, int bins, const float* __restrict__ tl,
           const float* __restrict__ hr, const float* __restrict__ hi, float b0,
           float* __restrict__ aext) {
    const int k = blockIdx.y * MAC_THREADS + threadIdx.x;
    if (k >= bins) return;
    const int t0 = blockIdx.x * MAC_TT;
    if (k == 0)
        mac_rows<true>(nb, nparts, bins, k, t0, tl, hr, hi, b0, aext);
    else
        mac_rows<false>(nb, nparts, bins, k, t0, tl, hr, hi, b0, aext);
}

// rows t < nb: outs[t] = ([acc[t-1] | acc[t]] @ w2 + (t == 0 ? tail0 : 0)) / pts;
// row nb: tailf = [acc[nb-1] | 0] @ w2
__global__ void __launch_bounds__(GEMM_THREADS)
post_ola_kernel(int nb, int pts, const float* __restrict__ aext,
                const float* __restrict__ w2, const float* __restrict__ tail0,
                float inv_pts, float* __restrict__ outs, float* __restrict__ tailf) {
    const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
    float acc[TM][TN];
    gemm_tile(nb + 1, pts, 4 * pts, aext, 2 * pts, w2, pts, row0, col0, acc);
    const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty * TM + i;
        if (r > nb) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = col0 + tx * TN + j;
            if (c >= pts) continue;
            if (r == nb)
                tailf[c] = acc[i][j];
            else
                outs[static_cast<size_t>(r) * pts + c] =
                    (acc[i][j] + (r == 0 ? tail0[c] : 0.f)) * inv_pts;
        }
    }
}

}  // namespace

// One LTI scan of nb blocks. All pointers are float32 device memory on
// `device`; the caller allocates outputs and scratch:
//   timeline (nparts+nb, 2*pts), aext (nb+2, 2*pts).
// Launches on `stream` without synchronising; returns the first CUDA error.
extern "C" int stream_steps_fused_f32(
    const float* blocks, const float* w0r, const float* w0i,
    const float* hr, const float* hi, const float* wfwd, const float* w2,
    const float* tail0, float* outs, float* wfr, float* wfi, float* tailf,
    float* timeline, float* aext, int nb, int nparts, int pts,
    float b0_scale, int device, void* stream_ptr) {
    cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
    const int bins = pts;
    const size_t b2 = 2 * static_cast<size_t>(bins);
    const size_t row_bytes = bins * sizeof(float);
    const size_t tl_pitch = b2 * sizeof(float);
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return e;

    // initial window -> timeline rows [0, nparts)
    e = cudaMemcpy2DAsync(timeline, tl_pitch, w0r, row_bytes, row_bytes, nparts,
                          cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return e;
    e = cudaMemcpy2DAsync(timeline + bins, tl_pitch, w0i, row_bytes, row_bytes,
                          nparts, cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return e;

    fwd_gemm_kernel<<<dim3(cdiv(nb, BM), cdiv(b2, BN)), GEMM_THREADS, 0, s>>>(
        nb, pts, static_cast<int>(b2), blocks, wfwd, timeline + nparts * b2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;

    e = cudaMemsetAsync(aext, 0, tl_pitch, s);
    if (e != cudaSuccess) return e;
    e = cudaMemsetAsync(aext + (nb + 1) * b2, 0, tl_pitch, s);
    if (e != cudaSuccess) return e;

    mac_kernel<<<dim3(cdiv(nb, MAC_TT), cdiv(bins, MAC_THREADS)), MAC_THREADS, 0, s>>>(
        nb, nparts, bins, timeline, hr, hi, b0_scale, aext);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;

    post_ola_kernel<<<dim3(cdiv(nb + 1, BM), cdiv(pts, BN)), GEMM_THREADS, 0, s>>>(
        nb, pts, aext, w2, tail0, 1.0f / static_cast<float>(pts), outs, tailf);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;

    // final window: timeline rows [nb, nb+nparts)
    e = cudaMemcpy2DAsync(wfr, row_bytes, timeline + nb * b2, tl_pitch, row_bytes,
                          nparts, cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return e;
    e = cudaMemcpy2DAsync(wfi, row_bytes, timeline + nb * b2 + bins, tl_pitch,
                          row_bytes, nparts, cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}
