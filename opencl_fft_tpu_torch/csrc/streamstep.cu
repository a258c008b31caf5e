// Whole-scan partitioned convolution on Hopper (sm_90a): LTI and
// time-varying (TV).
//
// Replaces the TPU kernels opencl_fft_tpu/ops/pallas/streamstep.py:
// _stream_kernel (wrapper stream_steps_fused) and _stream_tv_kernel (wrapper
// stream_steps_fused_tv). For every input block t they compute the same
// thing: forward rFFT of the zero-padded block as one matmul against wfwd, a
// one-frame slide of the spectral window, the frequency-delay-line complex MAC
// against the IR spectra (bin 0 componentwise, scaled by b0), one matmul
// against wpost (unpack + inverse DFT + deinterleave), overlap-add and
// division by pts. In the TV scan the IR spectra are a ring too: block t's
// coefficient frame (the forward rFFT of its second operand) is written at
// ring slot (wp2_0 - t) mod nparts before its MAC.
//
// What bounds it on the card. At the headline shape (pts = bins = 512,
// nparts = 256, nb = 1880 blocks) the forward product is nb * pts * 2b * 2
// ~ 2.0 GFLOP (twice that in the TV scan, which transforms both operands),
// the inverse product nb * 2b * 2b * 2 ~ 3.9 GFLOP and the MAC
// nb * nparts * bins * 8 ~ 2.0 GFLOP, all float32 (the JAX tables run at
// Precision.HIGHEST, so no TF32). The data is a few MB: the tables are 6 MB,
// each frame timeline 8.7 MB, the MAC output 7.7 MB, all L2-resident. So the
// scan is bound by FP32 FMA throughput, not by memory.
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
// The TV scan adds a second timeline HT of nparts-1+nb rows for the
// coefficient frames: row s+nparts-1 holds the frame of block s, and the
// nparts-1 prefix rows (pseudo-times s = -(nparts-1)..-1) are gathered from
// the initial ring at slot (wp2_0 - s) mod nparts. Ring slot q at block t
// then holds the frame of the last s <= t with s = wp2_0 - q (mod nparts),
// so the TV MAC is
//   acc[t, k] = sum_q T[t+1+q, k] * HT[t - ((t - wp2_0 + q) mod nparts)
//                                      + nparts - 1, k],
// the x rows sliding in registers as in the LTI MAC and the h row read per
// (q, block) from L2 (it changes only where the mod wraps, so neighbouring
// blocks read the same row). The final ring is the same gather at t = nb-1.
// Both products are one shared-memory tiled FP32 FMA SGEMM (sgemm_tile.cuh).
// The final window is timeline rows [nb, nb+nparts). wgmma/TMA products and
// a persistent variant for small nb are later work.

#include "sgemm_tile.cuh"

namespace {

using sgemm::BM;
using sgemm::BN;
using sgemm::TM;
using sgemm::TN;
using sgemm::cdiv;
using sgemm::gemm_tile;
constexpr int GEMM_THREADS = sgemm::THREADS;

constexpr int MAC_TT = 8;          // output blocks per MAC thread
constexpr int MAC_THREADS = 128;   // bins per MAC block
constexpr int ROW_THREADS = 128;   // bins per block of the ring gathers

__device__ __forceinline__ int pmod(int a, int n) {
    const int r = a % n;
    return r < 0 ? r + n : r;
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

// LTI: h is the (nparts, bins) IR ring, the same row q for every block.
// TV: h is the timeline HT (rows [re | im]); block t at partition q reads
// row t - ((t - wp2_0 + q) mod nparts) + nparts - 1.
template <bool DC, bool TV>
__device__ __forceinline__ void mac_rows(int nb, int nparts, int bins, int k, int t0,
                                         int wp2_0, const float* __restrict__ tl,
                                         const float* __restrict__ hr,
                                         const float* __restrict__ hi,
                                         float b0, float* __restrict__ aext) {
    const size_t b2 = 2 * static_cast<size_t>(bins);
    const int nrows = nparts + nb;
    float xr[MAC_TT], xi[MAC_TT], ar[MAC_TT], ai[MAC_TT];
    int m[MAC_TT];   // TV: (t0 + j - wp2_0 + q) mod nparts at the current q
    // window of block t0+j at partition q is timeline row t0+j+1+q
#pragma unroll
    for (int j = 0; j < MAC_TT; ++j) {
        const int r = t0 + 1 + j;
        xr[j] = r < nrows ? tl[r * b2 + k] : 0.f;
        xi[j] = r < nrows ? tl[r * b2 + bins + k] : 0.f;
        ar[j] = 0.f;
        ai[j] = 0.f;
        m[j] = TV ? pmod(t0 + j - wp2_0, nparts) : 0;
    }
    for (int q = 0; q < nparts; ++q) {
        float h_r = 0.f, h_i = 0.f;
        if (!TV) {
            h_r = hr[static_cast<size_t>(q) * bins + k];
            h_i = hi[static_cast<size_t>(q) * bins + k];
        }
#pragma unroll
        for (int j = 0; j < MAC_TT; ++j) {
            if (TV) {
                const int t = t0 + j;
                const size_t row = static_cast<size_t>(t - m[j] + nparts - 1);
                h_r = t < nb ? hr[row * b2 + k] : 0.f;
                h_i = t < nb ? hr[row * b2 + bins + k] : 0.f;
                m[j] = m[j] + 1 == nparts ? 0 : m[j] + 1;
            }
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

// aext[t+1] = [acc_re[t] | acc_im[t]] for t < nb. LTI: (hr, hi) are the IR
// planes; TV: hr is the coefficient timeline HT and hi is unused.
template <bool TV>
__global__ void __launch_bounds__(MAC_THREADS)
mac_kernel(int nb, int nparts, int bins, int wp2_0, const float* __restrict__ tl,
           const float* __restrict__ hr, const float* __restrict__ hi, float b0,
           float* __restrict__ aext) {
    const int k = blockIdx.y * MAC_THREADS + threadIdx.x;
    if (k >= bins) return;
    const int t0 = blockIdx.x * MAC_TT;
    if (k == 0)
        mac_rows<true, TV>(nb, nparts, bins, k, t0, wp2_0, tl, hr, hi, b0, aext);
    else
        mac_rows<false, TV>(nb, nparts, bins, k, t0, wp2_0, tl, hr, hi, b0, aext);
}

// HT rows [0, nparts-1): row j holds the initial ring's frame of pseudo-time
// s = j - (nparts-1), ring slot (wp2_0 - s) mod nparts.
__global__ void __launch_bounds__(ROW_THREADS)
h_prefix_kernel(int nparts, int bins, int wp2_0, const float* __restrict__ h0r,
                const float* __restrict__ h0i, float* __restrict__ ht) {
    const int j = blockIdx.x;
    const int k = blockIdx.y * ROW_THREADS + threadIdx.x;
    if (k >= bins) return;
    const size_t slot = pmod(wp2_0 - (j - (nparts - 1)), nparts);
    float* row = ht + static_cast<size_t>(j) * 2 * bins;
    row[k] = h0r[slot * bins + k];
    row[bins + k] = h0i[slot * bins + k];
}

// final ring slot q = HT row (nb-1) - ((nb-1 - wp2_0 + q) mod nparts) + nparts-1
__global__ void __launch_bounds__(ROW_THREADS)
h_final_kernel(int nb, int nparts, int bins, int wp2_0, const float* __restrict__ ht,
               float* __restrict__ hfr, float* __restrict__ hfi) {
    const int q = blockIdx.x;
    const int k = blockIdx.y * ROW_THREADS + threadIdx.x;
    if (k >= bins) return;
    const size_t r = nb - 1 - pmod(nb - 1 - wp2_0 + q, nparts) + nparts - 1;
    const float* row = ht + r * 2 * bins;
    hfr[static_cast<size_t>(q) * bins + k] = row[k];
    hfi[static_cast<size_t>(q) * bins + k] = row[bins + k];
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

// frames of `blocks` -> rows [row0, row0+nb) of a (., 2*pts) timeline
cudaError_t forward_frames(const float* blocks, const float* wfwd, float* timeline,
                           int row0, int nb, int pts, cudaStream_t s) {
    const int b2 = 2 * pts;
    fwd_gemm_kernel<<<dim3(cdiv(nb, BM), cdiv(b2, BN)), GEMM_THREADS, 0, s>>>(
        nb, pts, b2, blocks, wfwd, timeline + static_cast<size_t>(row0) * b2);
    return cudaGetLastError();
}

// split (rows, bins) planes <-> rows of a [re | im] timeline
cudaError_t planes_to_rows(const float* re, const float* im, float* rows, int nrows,
                           int bins, cudaStream_t s) {
    const size_t row_bytes = bins * sizeof(float), pitch = 2 * row_bytes;
    SGEMM_RETURN_IF_ERROR(cudaMemcpy2DAsync(rows, pitch, re, row_bytes, row_bytes, nrows,
                                            cudaMemcpyDeviceToDevice, s));
    return cudaMemcpy2DAsync(rows + bins, pitch, im, row_bytes, row_bytes, nrows,
                             cudaMemcpyDeviceToDevice, s);
}

cudaError_t rows_to_planes(const float* rows, float* re, float* im, int nrows, int bins,
                           cudaStream_t s) {
    const size_t row_bytes = bins * sizeof(float), pitch = 2 * row_bytes;
    SGEMM_RETURN_IF_ERROR(cudaMemcpy2DAsync(re, row_bytes, rows, pitch, row_bytes, nrows,
                                            cudaMemcpyDeviceToDevice, s));
    return cudaMemcpy2DAsync(im, row_bytes, rows + bins, pitch, row_bytes, nrows,
                             cudaMemcpyDeviceToDevice, s);
}

// The steps both scans share: the x timeline (initial window + frames), the
// MAC (LTI or TV) into aext, the post product with the overlap-add, and the
// final window.
template <bool TV>
cudaError_t run_scan(const float* blocks, const float* w0r, const float* w0i,
                     const float* hr, const float* hi, const float* wfwd,
                     const float* w2, const float* tail0, float* outs, float* wfr,
                     float* wfi, float* tailf, float* timeline, float* aext, int nb,
                     int nparts, int pts, int wp2_0, float b0_scale, cudaStream_t s) {
    const int bins = pts;
    const size_t b2 = 2 * static_cast<size_t>(bins);
    SGEMM_RETURN_IF_ERROR(planes_to_rows(w0r, w0i, timeline, nparts, bins, s));
    SGEMM_RETURN_IF_ERROR(forward_frames(blocks, wfwd, timeline, nparts, nb, pts, s));
    SGEMM_RETURN_IF_ERROR(cudaMemsetAsync(aext, 0, b2 * sizeof(float), s));
    SGEMM_RETURN_IF_ERROR(cudaMemsetAsync(aext + (nb + 1) * b2, 0, b2 * sizeof(float), s));
    mac_kernel<TV><<<dim3(cdiv(nb, MAC_TT), cdiv(bins, MAC_THREADS)), MAC_THREADS, 0, s>>>(
        nb, nparts, bins, wp2_0, timeline, hr, hi, b0_scale, aext);
    SGEMM_RETURN_IF_ERROR(cudaGetLastError());
    post_ola_kernel<<<dim3(cdiv(nb + 1, BM), cdiv(pts, BN)), GEMM_THREADS, 0, s>>>(
        nb, pts, aext, w2, tail0, 1.0f / static_cast<float>(pts), outs, tailf);
    SGEMM_RETURN_IF_ERROR(cudaGetLastError());
    // final window: timeline rows [nb, nb+nparts)
    return rows_to_planes(timeline + nb * b2, wfr, wfi, nparts, bins, s);
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
    SGEMM_RETURN_IF_ERROR(cudaSetDevice(device));
    return run_scan<false>(blocks, w0r, w0i, hr, hi, wfwd, w2, tail0, outs, wfr, wfi,
                           tailf, timeline, aext, nb, nparts, pts, 0, b0_scale,
                           static_cast<cudaStream_t>(stream_ptr));
}

// One TV scan of nb blocks: blocks_x / blocks_h (nb, pts) are the input and
// coefficient operands, (h0r, h0i) the initial coefficient ring and wp2_0 in
// [0, nparts) its pointer; (hfr, hfi) receive the final ring. Scratch:
//   timeline (nparts+nb, 2*pts), htimeline (nparts-1+nb, 2*pts),
//   aext (nb+2, 2*pts).
extern "C" int stream_steps_fused_tv_f32(
    const float* blocks_x, const float* blocks_h, const float* w0r, const float* w0i,
    const float* h0r, const float* h0i, const float* wfwd, const float* w2,
    const float* tail0, float* outs, float* wfr, float* wfi, float* hfr, float* hfi,
    float* tailf, float* timeline, float* htimeline, float* aext, int nb, int nparts,
    int pts, int wp2_0, float b0_scale, int device, void* stream_ptr) {
    cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
    const int bins = pts;
    SGEMM_RETURN_IF_ERROR(cudaSetDevice(device));
    if (nparts > 1) {
        h_prefix_kernel<<<dim3(nparts - 1, cdiv(bins, ROW_THREADS)), ROW_THREADS, 0, s>>>(
            nparts, bins, wp2_0, h0r, h0i, htimeline);
        SGEMM_RETURN_IF_ERROR(cudaGetLastError());
    }
    SGEMM_RETURN_IF_ERROR(forward_frames(blocks_h, wfwd, htimeline, nparts - 1, nb, pts, s));
    SGEMM_RETURN_IF_ERROR(run_scan<true>(blocks_x, w0r, w0i, htimeline, nullptr, wfwd, w2,
                                         tail0, outs, wfr, wfi, tailf, timeline, aext, nb,
                                         nparts, pts, wp2_0, b0_scale, s));
    h_final_kernel<<<dim3(nparts, cdiv(bins, ROW_THREADS)), ROW_THREADS, 0, s>>>(
        nb, nparts, bins, wp2_0, htimeline, hfr, hfi);
    return cudaGetLastError();
}
