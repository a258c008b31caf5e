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
// wgmma/TMA products and a persistent variant for small nb are later work.

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

// Sizes of one scan and the per-channel strides of its buffers: channel c
// of a buffer starts at c * (its stride). Blocks and outputs are (nb, C,
// pts): block t of channel c is row t*C + c.
struct Scan {
    int nb, C, nparts, bins;   // bins == pts
    __host__ __device__ size_t b2() const { return 2 * static_cast<size_t>(bins); }
    // window / IR / ring planes (nparts, bins)
    __host__ __device__ size_t plane() const { return static_cast<size_t>(nparts) * bins; }
    // rows of 2b: frame timeline (nparts+nb), coefficient timeline
    // (nparts-1+nb), MAC output with a zero row before and after (nb+2)
    __host__ __device__ size_t tl_rows() const { return static_cast<size_t>(nparts) + nb; }
    __host__ __device__ size_t ht_rows() const { return static_cast<size_t>(nparts) - 1 + nb; }
    __host__ __device__ size_t ax_rows() const { return static_cast<size_t>(nb) + 2; }
    __host__ __device__ size_t tl() const { return tl_rows() * b2(); }
    __host__ __device__ size_t ht() const { return ht_rows() * b2(); }
    __host__ __device__ size_t ax() const { return ax_rows() * b2(); }
};

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

// How a MAC thread finds the h row of each of its MAC_TT blocks at
// partition q. H_LTI: the IR ring, row q for every block. H_TV: the
// coefficient timeline HT, row t - ((t - wp2_0 + q) mod nparts) + nparts - 1
// for block t, any nparts. H_TV_PAIR (nparts >= MAC_TT): with
// m0 = (t0 - wp2_0 + q) mod nparts, blocks t0+j with m0 + j < nparts read
// row ra = t0 - m0 + nparts - 1 and the others (past the one wrap) row
// ra + nparts, so two row loads per q serve all MAC_TT blocks.
enum HMode { H_LTI, H_TV, H_TV_PAIR };

// One channel: its rows start at row tl0 of the timelines, h0 of the h
// planes (or of HT) and ax0 of aext, all indexed from the kernel-argument
// base pointers (per-channel base pointers measured slower in the MAC).
template <bool DC, HMode MODE>
__device__ __forceinline__ void mac_rows(int nb, int nparts, int bins, int k, int t0,
                                         int wp2_0, const float* __restrict__ tl,
                                         const float* __restrict__ hr,
                                         const float* __restrict__ hi, float b0,
                                         float* __restrict__ aext, size_t tl0, size_t h0,
                                         size_t ax0) {
    const size_t b2 = 2 * static_cast<size_t>(bins);
    const int nrows = nparts + nb;
    float xr[MAC_TT], xi[MAC_TT], ar[MAC_TT], ai[MAC_TT];
    int m[MAC_TT];   // H_TV: (t0 + j - wp2_0 + q) mod nparts at the current q
    int m0 = MODE == H_TV_PAIR ? pmod(t0 - wp2_0, nparts) : 0;
    // window of block t0+j at partition q is timeline row t0+j+1+q
#pragma unroll
    for (int j = 0; j < MAC_TT; ++j) {
        const int r = t0 + 1 + j;
        xr[j] = r < nrows ? tl[(tl0 + r) * b2 + k] : 0.f;
        xi[j] = r < nrows ? tl[(tl0 + r) * b2 + bins + k] : 0.f;
        ar[j] = 0.f;
        ai[j] = 0.f;
        m[j] = MODE == H_TV ? pmod(t0 + j - wp2_0, nparts) : 0;
    }
    for (int q = 0; q < nparts; ++q) {
        float h_r = 0.f, h_i = 0.f, g_r = 0.f, g_i = 0.f;
        int jw = MAC_TT;   // H_TV_PAIR: blocks j >= jw read the second row (g)
        if (MODE == H_LTI) {
            h_r = hr[(h0 + q) * bins + k];
            h_i = hi[(h0 + q) * bins + k];
        } else if (MODE == H_TV_PAIR) {
            const size_t ra = h0 + (t0 - m0 + nparts - 1);
            h_r = hr[ra * b2 + k];
            h_i = hr[ra * b2 + bins + k];
            jw = nparts - m0;
            if (jw < MAC_TT && t0 + jw < nb) {
                g_r = hr[(ra + nparts) * b2 + k];
                g_i = hr[(ra + nparts) * b2 + bins + k];
            }
            m0 = m0 + 1 == nparts ? 0 : m0 + 1;
        }
#pragma unroll
        for (int j = 0; j < MAC_TT; ++j) {
            float y_r = h_r, y_i = h_i;
            if (MODE == H_TV) {
                const int t = t0 + j;
                const size_t row = h0 + (t - m[j] + nparts - 1);
                y_r = t < nb ? hr[row * b2 + k] : 0.f;
                y_i = t < nb ? hr[row * b2 + bins + k] : 0.f;
                m[j] = m[j] + 1 == nparts ? 0 : m[j] + 1;
            } else if (MODE == H_TV_PAIR && j >= jw) {
                y_r = g_r;
                y_i = g_i;
            }
            if (DC) {            // packed (DC/2, Nyq/2) bin: componentwise
                ar[j] += xr[j] * y_r;
                ai[j] += xi[j] * y_i;
            } else {
                ar[j] += xr[j] * y_r - xi[j] * y_i;
                ai[j] += xr[j] * y_i + xi[j] * y_r;
            }
        }
#pragma unroll
        for (int j = 0; j < MAC_TT - 1; ++j) {
            xr[j] = xr[j + 1];
            xi[j] = xi[j + 1];
        }
        const int r = t0 + 1 + q + MAC_TT;
        xr[MAC_TT - 1] = r < nrows ? tl[(tl0 + r) * b2 + k] : 0.f;
        xi[MAC_TT - 1] = r < nrows ? tl[(tl0 + r) * b2 + bins + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < MAC_TT; ++j) {
        const int t = t0 + j;
        if (t >= nb) break;
        float* row = aext + (ax0 + t + 1) * b2;   // aext row t+1 holds acc[t]
        row[k] = DC ? b0 * ar[j] : ar[j];
        row[bins + k] = DC ? b0 * ai[j] : ai[j];
    }
}

// Channel c = blockIdx.z: aext_c[t+1] = [acc_re[t] | acc_im[t]] for t < nb.
// LTI: (hr, hi) are the IR planes (C, nparts, bins); TV: hr is the
// coefficient timelines and hi is unused; channel c's ring pointer is
// wp2[c * wp2_stride].
template <HMode MODE>
__global__ void __launch_bounds__(MAC_THREADS)
mac_kernel(Scan s, const int* __restrict__ wp2, int wp2_stride,
           const float* __restrict__ timeline, const float* __restrict__ hr,
           const float* __restrict__ hi, float b0, float* __restrict__ aext) {
    const int k = blockIdx.y * MAC_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const size_t c = blockIdx.z;
    const int t0 = blockIdx.x * MAC_TT;
    const size_t tl0 = c * s.tl_rows();
    const size_t h0 = c * (MODE == H_LTI ? s.nparts : s.ht_rows());
    const size_t ax0 = c * s.ax_rows();
    const int wp2_0 = MODE == H_LTI ? 0 : wp2[c * wp2_stride];
    if (k == 0)
        mac_rows<true, MODE>(s.nb, s.nparts, s.bins, k, t0, wp2_0, timeline, hr, hi, b0,
                             aext, tl0, h0, ax0);
    else
        mac_rows<false, MODE>(s.nb, s.nparts, s.bins, k, t0, wp2_0, timeline, hr, hi, b0,
                              aext, tl0, h0, ax0);
}

// window planes (C, nparts, bins) -> rows [0, nparts) of each channel's
// [re | im] timeline
__global__ void __launch_bounds__(ROW_THREADS)
window_in_kernel(Scan s, const float* __restrict__ re, const float* __restrict__ im,
                 float* __restrict__ timeline, float* __restrict__ aext) {
    const int j = blockIdx.x, c = blockIdx.z;
    const int k = blockIdx.y * ROW_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    if (j == 0) {             // the zero rows 0 and nb+1 of the channel's aext
        float* ax = aext + c * s.ax();
        float* last = ax + (s.nb + 1) * s.b2();
        ax[k] = ax[s.bins + k] = last[k] = last[s.bins + k] = 0.f;
    }
    const size_t src = c * s.plane() + static_cast<size_t>(j) * s.bins + k;
    float* row = timeline + c * s.tl() + j * s.b2();
    row[k] = re[src];
    row[s.bins + k] = im[src];
}

// final window: timeline rows [nb, nb+nparts) of each channel -> planes
__global__ void __launch_bounds__(ROW_THREADS)
window_out_kernel(Scan s, const float* __restrict__ timeline, float* __restrict__ re,
                  float* __restrict__ im) {
    const int q = blockIdx.x, c = blockIdx.z;
    const int k = blockIdx.y * ROW_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const float* row = timeline + c * s.tl() + (static_cast<size_t>(s.nb) + q) * s.b2();
    const size_t dst = c * s.plane() + static_cast<size_t>(q) * s.bins + k;
    re[dst] = row[k];
    im[dst] = row[s.bins + k];
}

// HT_c rows [0, nparts-1): row j holds the initial ring's frame of
// pseudo-time s = j - (nparts-1), ring slot (wp2_c - s) mod nparts.
__global__ void __launch_bounds__(ROW_THREADS)
h_prefix_kernel(Scan s, const int* __restrict__ wp2, int wp2_stride,
                const float* __restrict__ h0r, const float* __restrict__ h0i,
                float* __restrict__ ht) {
    const int j = blockIdx.x, c = blockIdx.z;
    const int k = blockIdx.y * ROW_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const int slot = pmod(wp2[c * wp2_stride] - (j - (s.nparts - 1)), s.nparts);
    const size_t src = c * s.plane() + static_cast<size_t>(slot) * s.bins + k;
    float* row = ht + c * s.ht() + j * s.b2();
    row[k] = h0r[src];
    row[s.bins + k] = h0i[src];
}

// final ring slot q of channel c = HT_c row
// (nb-1) - ((nb-1 - wp2_c + q) mod nparts) + nparts-1
__global__ void __launch_bounds__(ROW_THREADS)
h_final_kernel(Scan s, const int* __restrict__ wp2, int wp2_stride,
               const float* __restrict__ ht, float* __restrict__ hfr,
               float* __restrict__ hfi) {
    const int q = blockIdx.x, c = blockIdx.z;
    const int k = blockIdx.y * ROW_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const int nb = s.nb, nparts = s.nparts;
    const size_t r = nb - 1 - pmod(nb - 1 - wp2[c * wp2_stride] + q, nparts) + nparts - 1;
    const float* row = ht + c * s.ht() + r * s.b2();
    const size_t dst = c * s.plane() + static_cast<size_t>(q) * s.bins + k;
    hfr[dst] = row[k];
    hfi[dst] = row[s.bins + k];
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

// frames of `blocks` (nb, C, pts) -> rows [row0, row0+nb) of each channel's
// timeline (channel stride tl_cs)
cudaError_t forward_frames(const Scan& s, const float* blocks, const float* wfwd,
                           float* tl, size_t tl_cs, int row0, cudaStream_t st) {
    fwd_gemm_kernel<<<dim3(cdiv(static_cast<long long>(s.nb) * s.C, BM),
                           cdiv(2 * s.bins, BN)),
                      GEMM_THREADS, 0, st>>>(s, row0, blocks, wfwd, tl, tl_cs);
    return cudaGetLastError();
}

// The steps both scans share: the x timelines (initial windows + frames),
// the MAC (LTI or TV) into aext, the post product with the overlap-add, and
// the final windows.
template <bool TV>
cudaError_t run_scan(const Scan& s, const float* blocks, const float* w0r, const float* w0i,
                     const float* hr, const float* hi, const int* wp2, int wp2_stride,
                     const float* wfwd, const float* w2, const float* tail0, float* outs,
                     float* wfr, float* wfi, float* tailf, float* timeline, float* aext,
                     float b0_scale, cudaStream_t st) {
    const dim3 rows(s.nparts, cdiv(s.bins, ROW_THREADS), s.C);
    window_in_kernel<<<rows, ROW_THREADS, 0, st>>>(s, w0r, w0i, timeline, aext);
    SGEMM_RETURN_IF_ERROR(cudaGetLastError());
    SGEMM_RETURN_IF_ERROR(forward_frames(s, blocks, wfwd, timeline, s.tl(), s.nparts, st));
    const dim3 mac(cdiv(s.nb, MAC_TT), cdiv(s.bins, MAC_THREADS), s.C);
    if (!TV)
        mac_kernel<H_LTI><<<mac, MAC_THREADS, 0, st>>>(s, wp2, wp2_stride, timeline, hr, hi,
                                                        b0_scale, aext);
    else if (s.nparts >= MAC_TT)
        mac_kernel<H_TV_PAIR><<<mac, MAC_THREADS, 0, st>>>(s, wp2, wp2_stride, timeline, hr,
                                                            hi, b0_scale, aext);
    else
        mac_kernel<H_TV><<<mac, MAC_THREADS, 0, st>>>(s, wp2, wp2_stride, timeline, hr, hi,
                                                       b0_scale, aext);
    SGEMM_RETURN_IF_ERROR(cudaGetLastError());
    post_ola_kernel<<<dim3(cdiv(s.nb + 1, BM), cdiv(s.bins, BN), s.C), GEMM_THREADS, 0, st>>>(
        s, aext, w2, tail0, 1.0f / static_cast<float>(s.bins), outs, tailf);
    SGEMM_RETURN_IF_ERROR(cudaGetLastError());
    window_out_kernel<<<rows, ROW_THREADS, 0, st>>>(s, timeline, wfr, wfi);
    return cudaGetLastError();
}

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
    return run_scan<false>(s, blocks, w0r, w0i, hr, hi, nullptr, 0, wfwd, w2, tail0, outs,
                           wfr, wfi, tailf, timeline, aext, b0_scale,
                           static_cast<cudaStream_t>(stream_ptr));
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
    cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
    SGEMM_RETURN_IF_ERROR(cudaSetDevice(device));
    const Scan s{nb, C, nparts, pts};
    if (nparts > 1) {
        h_prefix_kernel<<<dim3(nparts - 1, cdiv(pts, ROW_THREADS), C), ROW_THREADS, 0, st>>>(
            s, wp2, wp2_stride, h0r, h0i, htimeline);
        SGEMM_RETURN_IF_ERROR(cudaGetLastError());
    }
    SGEMM_RETURN_IF_ERROR(forward_frames(s, blocks_h, wfwd, htimeline, s.ht(), nparts - 1, st));
    SGEMM_RETURN_IF_ERROR(run_scan<true>(s, blocks_x, w0r, w0i, htimeline, nullptr, wp2,
                                         wp2_stride, wfwd, w2, tail0, outs, wfr, wfi, tailf,
                                         timeline, aext, b0_scale, st));
    h_final_kernel<<<dim3(nparts, cdiv(pts, ROW_THREADS), C), ROW_THREADS, 0, st>>>(
        s, wp2, wp2_stride, htimeline, hfr, hfi);
    return cudaGetLastError();
}
