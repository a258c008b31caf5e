// Whole-scan partitioned convolution on the factored transform tables, on
// Hopper (sm_90a): LTI and time-varying (TV), for C channels at once (C = 1
// is the single-channel scan).
//
// Replaces the TPU kernels of opencl_fft_tpu/ops/pallas/splitstep.py:
// _split_stream_kernel (wrapper stream_steps_fused_split :367) and
// _split_stream_tv_kernel (stream_steps_fused_split_tv :493). They compute
// the scans of streamstep.cu (the same window slide, MAC, TV ring walk and
// overlap-add, shared through scan_mac.cuh) with both transform chains
// factored through one (m, m) table, m = pts = bins:
//   ctab[k, q] = cos(2 pi (q/2) k / m) for q even, sin(...) for q odd,
// plus (8, m) coefficient stacks (ops/cuda/tables.py), instead of the dense
// (m, 2m) and (2m, 2m) tables: 1 m^2 table where the dense ones take 6 m^2
// (100 MB at m = 2048, 400 MB at 4096). Per block the JAX chain is
//   forward: [x, psw(x), x*pm, psw(x)*pm] @ ctab^T -> FR, FI, GR, GI, then
//     re = FR a1 + GR a2 + FI b1 + GI b2, im = FR c1 + GR c2 + FI d1 + GI d2
//     (psw(x)_q = x_{q+1} for q even, -x_{q-1} for q odd; pm = (-1)^q);
//   inverse: A, B, D, E = the four coefficient combos of (acc_re, acc_im),
//     [A, B, D, E, A pm, B pm, D pm, E pm] @ ctab -> ya .. ye2,
//     out1 = (ya + yb pm) + sw(yd + ye pm), out2 likewise from the pm rows
//     (sw(v)_q = -v_{q+1} for q even, v_{q-1} for q odd), and the block's
//     output is (out1[t] + out2[t-1]) / pts.
//
// What bounds it on the card. At pts 4096 with a 2^20-tap IR (nparts 256)
// and 470 blocks, the least work is the MAC (8 nb nparts bins = 3.94 GFLOP)
// and the transforms (0.25 GFLOP): 0.063 ms at 67 TFLOP/s. The factored
// chain's products are dense DFTs, O(m^2) a block: 4 nb m^2 * 2 = 63 GFLOP
// forward (126 in the TV scan) and, with the overlap-add folded in as
// below, 4 (nb+1) m^2 * 2 = 63 GFLOP inverse, all FP32 FMA (the JAX tables
// run at Precision.HIGHEST: no TF32). So the products bound it, at the
// SGEMM tile's rate.
//
// What the design does about it. The TPU kernel walks 8-block groups in
// sequence with the tables and state in VMEM. Here every block is known up
// front, as in streamstep.cu, and the products run over all blocks of all
// channels at once on the SGEMM tile of sgemm_tile.cuh, with the row
// stacks never stored (at 16 channels x 470 blocks x 4096 the stacks would
// be 0.5-1 GB):
//   1. split_fwd_kernel: logical row 4 (t*C + c) + v of the A operand is
//      variant v of block t of channel c, computed as the tile loads it; a
//      thread's 4 accumulator rows are the 4 variants of one block, so the
//      pack with the 8 forward coefficients is its epilogue, which writes
//      row row0 + t of channel c's timeline.
//   2. the timeline MAC of scan_mac.cuh (H_LTI / H_TV_PAIR / H_TV).
//   3. split_post_kernel: the overlap-add is folded into the inverse
//      product. out1[t] + out2[t-1] is linear, and out2's rows are out1's
//      rows times pm before the same ctab, so logical row 4t + v of the A
//      operand (t = 0..nb, channel c = blockIdx.z) is
//        z_v(acc[t]) + pm * z_v(acc[t-1]),   z = A, B, D, E,
//      read from aext (zero rows at acc[-1] and acc[nb]), and a thread's 4
//      rows give Ya..Ye of output row t: its epilogue forms (Ya + Yb pm) +
//      sw(Yd + Ye pm) over its 4 adjacent columns (sw pairs columns 2i and
//      2i+1, both in the thread), adds the carried tail at t = 0 and
//      divides by pts; row nb is the final tail. One product of 4 (nb+1)
//      rows instead of 8 nb.
// An in-kernel FFT (the radix-16 passes of fft.cu) instead of the dense
// products is the way to the bound; it is later work.

#include "scan_mac.cuh"

namespace {

using sgemm::BM;
using sgemm::BN;
using sgemm::Strided;
using sgemm::TM;
using sgemm::TN;
using sgemm::gemm_tile_ld;
constexpr int GEMM_THREADS = sgemm::THREADS;
static_assert(TM == 4, "a thread's rows are the 4 variants of one block");
static_assert(TN % 2 == 0, "sw pairs columns 2i and 2i+1 within a thread");

// A operand of the forward product: row 4*br + v, column k of
// [x, psw(x), x*pm, psw(x)*pm] for block row br of blocks (rows of pts)
struct FwdRows {
    const float* blocks;
    int pts;
    __device__ __forceinline__ float operator()(int r, int k) const {
        const float* x = blocks + static_cast<size_t>(r >> 2) * pts;
        const int v = r & 3;
        float val = (v & 1) ? ((k & 1) ? -__ldg(x + k - 1) : __ldg(x + k + 1)) : __ldg(x + k);
        return ((v & 2) && (k & 1)) ? -val : val;
    }
};

// A operand of the inverse product of one channel: row 4t + v, column k of
// z_v(acc[t]) + pm * z_v(acc[t-1]), z_v(a) = a_re * ic[2v] + a_im * ic[2v+1];
// aext row t+1 holds [acc_re[t] | acc_im[t]]
struct InvRows {
    const float* aext;
    const float* icoef;
    int m;
    __device__ __forceinline__ float operator()(int r, int k) const {
        const size_t b2 = 2 * static_cast<size_t>(m);
        const int v = r & 3;
        const float* cur = aext + static_cast<size_t>((r >> 2) + 1) * b2;
        const float* prev = cur - b2;
        const float c1 = __ldg(icoef + 2 * v * m + k), c2 = __ldg(icoef + (2 * v + 1) * m + k);
        const float zc = cur[k] * c1 + cur[m + k] * c2;
        const float zp = prev[k] * c1 + prev[m + k] * c2;
        return (k & 1) ? zc - zp : zc + zp;
    }
};

// frames of blocks (nb*C rows of pts, row t*C + c) -> row row0 + t of
// channel c's timeline (channel stride tl_cs)
__global__ void __launch_bounds__(GEMM_THREADS)
split_fwd_kernel(Scan s, int row0, const float* __restrict__ blocks,
                 const float* __restrict__ ctab_t, const float* __restrict__ fcoef,
                 float* __restrict__ tl, size_t tl_cs) {
    const int nrows = s.nb * s.C, m = s.bins;
    const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
    float acc[TM][TN];
    gemm_tile_ld(4 * nrows, m, m, FwdRows{blocks, m}, Strided{ctab_t, m}, r0, c0, acc);
    const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
    const int br = r0 / 4 + ty;
    if (br >= nrows) return;
    const int t = br / s.C, c = br - t * s.C;
    float* row = tl + c * tl_cs + static_cast<size_t>(row0 + t) * s.b2();
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const int col = c0 + tx * TN + j;
        if (col >= m) continue;
        const float fr = acc[0][j], fi = acc[1][j], gr = acc[2][j], gi = acc[3][j];
        const float* fc = fcoef + col;
        row[col] = fr * fc[0] + gr * fc[m] + fi * fc[2 * m] + gi * fc[3 * m];
        row[m + col] = fr * fc[4 * m] + gr * fc[5 * m] + fi * fc[6 * m] + gi * fc[7 * m];
    }
}

// Channel c = blockIdx.z. Rows t < nb: outs[t*C + c] = (out1(acc[t]) +
// out2(acc[t-1]) + (t == 0 ? tail0_c : 0)) / pts; row nb: tailf_c =
// out2(acc[nb-1])
__global__ void __launch_bounds__(GEMM_THREADS)
split_post_kernel(Scan s, const float* __restrict__ aext, const float* __restrict__ ctab,
                  const float* __restrict__ icoef, const float* __restrict__ tail0,
                  float inv_pts, float* __restrict__ outs, float* __restrict__ tailf) {
    const int nb = s.nb, m = s.bins, c = blockIdx.z;
    const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
    float acc[TM][TN];
    gemm_tile_ld(4 * (nb + 1), m, m, InvRows{aext + c * s.ax(), icoef, m}, Strided{ctab, m},
                 r0, c0, acc);
    const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
    const int t = r0 / 4 + ty;
    if (t > nb) return;
    float zr[TN], zi[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const bool odd = (c0 + tx * TN + j) & 1;
        zr[j] = odd ? acc[0][j] - acc[1][j] : acc[0][j] + acc[1][j];
        zi[j] = odd ? acc[2][j] - acc[3][j] : acc[2][j] + acc[3][j];
    }
    const size_t chan = static_cast<size_t>(c) * m;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const int col = c0 + tx * TN + j;
        if (col >= m) continue;
        const float y = zr[j] + ((j & 1) ? zi[j - 1] : -zi[j + 1]);
        if (t == nb)
            tailf[chan + col] = y;
        else
            outs[static_cast<size_t>(t) * s.C * m + chan + col] =
                (y + (t == 0 ? tail0[chan + col] : 0.f)) * inv_pts;
    }
}

// steps 1 and 3 of the factored scans, as run_scan takes them
struct SplitFwd {
    const float* ctab_t;
    const float* fcoef;
    cudaError_t operator()(const Scan& s, const float* blocks, float* tl, size_t tl_cs,
                           int row0, cudaStream_t st) const {
        split_fwd_kernel<<<dim3(cdiv(4LL * s.nb * s.C, BM), cdiv(s.bins, BN)), GEMM_THREADS,
                           0, st>>>(s, row0, blocks, ctab_t, fcoef, tl, tl_cs);
        return cudaGetLastError();
    }
};

struct SplitPost {
    const float* ctab;
    const float* icoef;
    cudaError_t operator()(const Scan& s, const float* aext, const float* tail0, float* outs,
                           float* tailf, cudaStream_t st) const {
        split_post_kernel<<<dim3(cdiv(4LL * (s.nb + 1), BM), cdiv(s.bins, BN), s.C),
                            GEMM_THREADS, 0, st>>>(s, aext, ctab, icoef, tail0,
                                                   1.0f / static_cast<float>(s.bins), outs,
                                                   tailf);
        return cudaGetLastError();
    }
};

}  // namespace

// One LTI scan of nb blocks of C channels on the factored tables. All
// pointers are float32 device memory on `device`; blocks and outs are (nb,
// C, pts), the windows and IR planes (C, nparts, pts), the tails (C, pts),
// ctab and ctab_t (pts, pts), fcoef and icoef (8, pts). The caller
// allocates outputs and scratch:
//   timeline (C, nparts+nb, 2*pts), aext (C, nb+2, 2*pts).
// Launches on `stream` without synchronising; returns the first CUDA error.
extern "C" int stream_steps_fused_split_batched_f32(
    const float* blocks, const float* w0r, const float* w0i, const float* hr, const float* hi,
    const float* ctab, const float* ctab_t, const float* fcoef, const float* icoef,
    const float* tail0, float* outs, float* wfr, float* wfi, float* tailf, float* timeline,
    float* aext, int nb, int C, int nparts, int pts, float b0_scale, int device,
    void* stream_ptr) {
    SGEMM_RETURN_IF_ERROR(cudaSetDevice(device));
    const Scan s{nb, C, nparts, pts};
    return run_scan<false>(s, blocks, w0r, w0i, hr, hi, nullptr, 0, SplitFwd{ctab_t, fcoef},
                           SplitPost{ctab, icoef}, tail0, outs, wfr, wfi, tailf, timeline,
                           aext, b0_scale, static_cast<cudaStream_t>(stream_ptr));
}

// One TV scan of nb blocks of C channels on the factored tables: blocks_x /
// blocks_h (nb, C, pts), initial coefficient rings (h0r, h0i) (C, nparts,
// pts), channel c's ring pointer wp2[c * wp2_stride] in [0, nparts) (int32
// device memory; stride 0 shares one pointer); (hfr, hfi) receive the final
// rings. Scratch as the LTI scan's, plus htimeline (C, nparts-1+nb, 2*pts).
extern "C" int stream_steps_fused_split_batched_tv_f32(
    const float* blocks_x, const float* blocks_h, const float* w0r, const float* w0i,
    const float* h0r, const float* h0i, const int* wp2, int wp2_stride, const float* ctab,
    const float* ctab_t, const float* fcoef, const float* icoef, const float* tail0,
    float* outs, float* wfr, float* wfi, float* hfr, float* hfi, float* tailf,
    float* timeline, float* htimeline, float* aext, int nb, int C, int nparts, int pts,
    float b0_scale, int device, void* stream_ptr) {
    SGEMM_RETURN_IF_ERROR(cudaSetDevice(device));
    const Scan s{nb, C, nparts, pts};
    return run_tv_scan(s, blocks_x, blocks_h, w0r, w0i, h0r, h0i, wp2, wp2_stride,
                       SplitFwd{ctab_t, fcoef}, SplitPost{ctab, icoef}, tail0, outs, wfr, wfi,
                       hfr, hfi, tailf, timeline, htimeline, aext, b0_scale,
                       static_cast<cudaStream_t>(stream_ptr));
}
