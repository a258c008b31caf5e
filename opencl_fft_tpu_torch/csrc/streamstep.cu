// Whole-scan partitioned convolution on Hopper (sm_90a): LTI and
// time-varying (TV), for C channels at once (C = 1 is the single-channel
// scan).
//
// Replaces the TPU kernels of opencl_fft_tpu/ops/pallas/streamstep.py:
// _stream_kernel (wrapper stream_steps_fused), _stream_tv_kernel
// (stream_steps_fused_tv), _stream_batched_kernel :447
// (stream_steps_fused_batched) and _stream_batched_tv_kernel :607
// (stream_steps_fused_batched_tv). For every input block t of every channel
// c they compute the same thing: forward rFFT of the zero-padded block as
// one matmul against wfwd, a one-frame slide of the channel's spectral
// window, the frequency-delay-line complex MAC against the channel's IR
// spectra (bin 0 componentwise, scaled by b0), one matmul against wpost
// (unpack + inverse DFT + deinterleave), overlap-add with the channel's
// tail and division by pts. In the TV scan the IR spectra are a ring too:
// block t's coefficient frame (the forward rFFT of its second operand) is
// written at ring slot (wp2_c - t) mod nparts before its MAC, wp2_c being
// channel c's ring pointer.
//
// What bounds it on the card. At the 64-channel serving shape (C = 64,
// pts = bins = 512, nparts = 256, nb = 470) the forward product is
// nb * C * pts * 2b * 2 ~ 31.5 GFLOP (twice that in the TV scan, which
// transforms both operands), the MAC nb * C * nparts * bins * 8 ~ 31.5 GFLOP
// and the inverse product (nb+1) * C * 2b * 2b * 2 ~ 63.2 GFLOP, all float32
// (the JAX tables run at Precision.HIGHEST, so no TF32). The scratch is
// ~0.3 GB (per-channel timelines ~190 MB, the MAC output ~124 MB; TV adds
// ~190 MB of coefficient timelines), read a few times: the scan is bound by
// FP32 FMA throughput, not by memory. At one channel (pts 512, nparts 256,
// nb 1880) the same holds with ~25 MB of L2-resident data.
//
// What the design does about it. The TPU kernels walk the blocks as a
// sequential grid with the windows, h and the tables resident in VMEM, and
// the batched ones stack the channels along the sublane axis with one-hot
// scatter/reduce matmuls; a Hopper block has 227 KB of shared memory and
// blocks run in no order. But every input block of a scan is known up
// front, so the sequence dissolves, and the channel index is a grid
// dimension:
//   1. fwd_gemm_kernel: F = blocks (nb*C, pts) @ wfwd (pts, 2b), one GEMM
//      over every channel; row t*C + c lands in row nparts + t of channel
//      c's frame timeline, whose rows [0, nparts) are its initial window w0
//      (row q = frame wp0+q). Window t is rows [t+1, t+1+nparts).
//   2. mac_kernel: acc[c, t, k] = sum_q T_c[t+1+q, k] * h_c[q, k], one
//      thread per bin k and MAC_TT consecutive blocks, the TT window rows
//      held in registers and slid by one row per q, so each timeline and h
//      element is loaded once per TT outputs. Bin 0 takes its own loop. The
//      channel is the slowest grid dimension, so a channel's blocks run
//      together and its timeline (~3 MB at the serving shape) and 1 MB h
//      ring are read from L2 by all of them; the timelines of all channels
//      (~190 MB) would not fit in L2 at once.
//   3. post_ola_kernel: the overlap-add is folded into the second product.
//      acc of channel c is stored with a zero row before and after it
//      (aext_c), so the (nb+1, 4b) matrix whose row t is
//      [acc[t-1] | acc[t]] is aext_c read with row stride 2b. Against
//      [wpost[:, b:] ; wpost[:, :b]] its row t is y[t-1, b:] + y[t, :b]:
//      rows t < nb are the outputs (plus the carried tail at t = 0, then
//      / pts), stored at row t*C + c; row nb is the final tail.
// The TV scan adds a second timeline HT_c of nparts-1+nb rows per channel
// for the coefficient frames: row s+nparts-1 holds the frame of block s,
// and the nparts-1 prefix rows (pseudo-times s = -(nparts-1)..-1) are
// gathered from the initial ring at slot (wp2_c - s) mod nparts. Ring slot
// q at block t then holds the frame of the last s <= t with
// s = wp2_c - q (mod nparts), so the TV MAC is
//   acc[c, t, k] = sum_q T_c[t+1+q, k] * HT_c[t - ((t - wp2_c + q) mod nparts)
//                                             + nparts - 1, k],
// the x rows sliding in registers as in the LTI MAC. The h row changes only
// where the mod wraps, so for nparts >= MAC_TT a thread's MAC_TT blocks read
// one of two rows per q: two row loads per q serve them all (H_TV_PAIR);
// smaller nparts read one row per block. The final ring is the same gather
// at t = nb-1.
// Ring pointers come per channel (an array read with a stride: 0 for one
// shared pointer, 1 for one each), so shared and per-channel pointers are
// one code path. Both products are one shared-memory tiled FP32 FMA SGEMM
// (sgemm_tile.cuh). The final window is timeline rows [nb, nb+nparts).
// The timelines, the MAC, the ring gathers and the order of the steps are
// shared with the split scans (scan_mac.cuh, splitstep.cu); this
// file holds the two dense products (steps 1 and 3).
// wgmma/TMA products and a persistent variant for small nb are later work.

#include "scan_mac.cuh"

namespace {

using sgemm::BM;
using sgemm::BN;
using sgemm::TM;
using sgemm::TN;
using sgemm::gemm_tile;
constexpr int GEMM_THREADS = sgemm::THREADS;

// rows t*C + c of blocks (nb*C, pts) @ wfwd (pts, 2b) -> row row0 + t of
// channel c's timeline (channel stride tl_cs)
__global__ void __launch_bounds__(GEMM_THREADS)
fwd_gemm_kernel(Scan s, int row0, const float* __restrict__ blocks,
                const float* __restrict__ wfwd, float* __restrict__ tl, size_t tl_cs) {
    const int m = s.nb * s.C, pts = s.bins, b2 = 2 * pts;
    const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
    float acc[TM][TN];
    gemm_tile(m, b2, pts, blocks, pts, wfwd, b2, r0, c0, acc);
    const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = r0 + ty * TM + i;
        if (r >= m) continue;
        const int t = r / s.C, c = r - t * s.C;
        float* row = tl + c * tl_cs + static_cast<size_t>(row0 + t) * b2;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = c0 + tx * TN + j;
            if (col < b2) row[col] = acc[i][j];
        }
    }
}

// Channel c = blockIdx.z. Rows t < nb: outs[t*C + c] =
// ([acc[t-1] | acc[t]] @ w2 + (t == 0 ? tail0_c : 0)) / pts;
// row nb: tailf_c = [acc[nb-1] | 0] @ w2
__global__ void __launch_bounds__(GEMM_THREADS)
post_ola_kernel(Scan s, const float* __restrict__ aext, const float* __restrict__ w2,
                const float* __restrict__ tail0, float inv_pts, float* __restrict__ outs,
                float* __restrict__ tailf) {
    const int nb = s.nb, pts = s.bins, c = blockIdx.z;
    const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
    float acc[TM][TN];
    gemm_tile(nb + 1, pts, 4 * pts, aext + c * s.ax(), 2 * pts, w2, pts, r0, c0, acc);
    const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
    const size_t chan = static_cast<size_t>(c) * pts;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = r0 + ty * TM + i;
        if (r > nb) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = c0 + tx * TN + j;
            if (col >= pts) continue;
            if (r == nb)
                tailf[chan + col] = acc[i][j];
            else
                outs[static_cast<size_t>(r) * s.C * pts + chan + col] =
                    (acc[i][j] + (r == 0 ? tail0[chan + col] : 0.f)) * inv_pts;
        }
    }
}

// steps 1 and 3 of the dense scans, as run_scan takes them
struct DenseFwd {
    const float* wfwd;
    // frames of `blocks` (nb, C, pts) -> rows [row0, row0+nb) of each
    // channel's timeline (channel stride tl_cs)
    cudaError_t operator()(const Scan& s, const float* blocks, float* tl, size_t tl_cs,
                           int row0, cudaStream_t st) const {
        fwd_gemm_kernel<<<dim3(cdiv(static_cast<long long>(s.nb) * s.C, BM),
                               cdiv(2 * s.bins, BN)),
                          GEMM_THREADS, 0, st>>>(s, row0, blocks, wfwd, tl, tl_cs);
        return cudaGetLastError();
    }
};

struct DensePost {
    const float* w2;
    cudaError_t operator()(const Scan& s, const float* aext, const float* tail0, float* outs,
                           float* tailf, cudaStream_t st) const {
        post_ola_kernel<<<dim3(cdiv(s.nb + 1, BM), cdiv(s.bins, BN), s.C), GEMM_THREADS, 0,
                          st>>>(s, aext, w2, tail0, 1.0f / static_cast<float>(s.bins), outs,
                                tailf);
        return cudaGetLastError();
    }
};

}  // namespace

// One LTI scan of nb blocks of C channels. All pointers are float32 device
// memory on `device`; blocks and outs are (nb, C, pts), the windows and IR
// planes (C, nparts, pts), the tails (C, pts). The caller allocates outputs
// and scratch:
//   timeline (C, nparts+nb, 2*pts), aext (C, nb+2, 2*pts).
// Launches on `stream` without synchronising; returns the first CUDA error.
extern "C" int stream_steps_fused_batched_f32(
    const float* blocks, const float* w0r, const float* w0i,
    const float* hr, const float* hi, const float* wfwd, const float* w2,
    const float* tail0, float* outs, float* wfr, float* wfi, float* tailf,
    float* timeline, float* aext, int nb, int C, int nparts, int pts,
    float b0_scale, int device, void* stream_ptr) {
    SGEMM_RETURN_IF_ERROR(cudaSetDevice(device));
    const Scan s{nb, C, nparts, pts};
    return run_scan<false>(s, blocks, w0r, w0i, hr, hi, nullptr, 0, DenseFwd{wfwd},
                           DensePost{w2}, tail0, outs, wfr, wfi, tailf, timeline, aext,
                           b0_scale, static_cast<cudaStream_t>(stream_ptr));
}

// One TV scan of nb blocks of C channels: blocks_x / blocks_h (nb, C, pts)
// are the input and coefficient operands, (h0r, h0i) the initial
// coefficient rings (C, nparts, pts); channel c's ring pointer, in
// [0, nparts), is wp2[c * wp2_stride] (int32 device memory; stride 0 shares
// one pointer). (hfr, hfi) receive the final rings. Scratch:
//   timeline (C, nparts+nb, 2*pts), htimeline (C, nparts-1+nb, 2*pts),
//   aext (C, nb+2, 2*pts).
extern "C" int stream_steps_fused_batched_tv_f32(
    const float* blocks_x, const float* blocks_h, const float* w0r, const float* w0i,
    const float* h0r, const float* h0i, const int* wp2, int wp2_stride,
    const float* wfwd, const float* w2, const float* tail0, float* outs, float* wfr,
    float* wfi, float* hfr, float* hfi, float* tailf, float* timeline, float* htimeline,
    float* aext, int nb, int C, int nparts, int pts, float b0_scale, int device,
    void* stream_ptr) {
    SGEMM_RETURN_IF_ERROR(cudaSetDevice(device));
    const Scan s{nb, C, nparts, pts};
    return run_tv_scan(s, blocks_x, blocks_h, w0r, w0i, h0r, h0i, wp2, wp2_stride,
                       DenseFwd{wfwd}, DensePost{w2}, tail0, outs, wfr, wfi, hfr, hfi, tailf,
                       timeline, htimeline, aext, b0_scale,
                       static_cast<cudaStream_t>(stream_ptr));
}
