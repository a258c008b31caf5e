// Sliding-window spectral MAC over frame timelines on Hopper (sm_90a), C
// channels at once: LTI (slide_mac_batched_f32) and time-varying
// (slide_mac_tv_batched_f32, at the end of this file).
//
// The LTI entry replaces three TPU kernels that compute one function:
// opencl_fft_tpu/ops/pallas/chunkmac.py _chunkmac_kernel (wrapper chunk_mac
// :158), macflow.py _lti_kernel (macflow_lti :252) and _lti_batched_kernel
// (macflow_lti_batched :367). For every channel c, output row t < nout and
// bin k:
//   acc[c, t, k] = sum_{q < nparts} X[c, t+q, k] (*) H[c, q, k]
// a complex product except at bin 0, the packed (DC/2, Nyq/2) pair, which
// multiplies componentwise and is scaled by b0 (cl_conv_kernels.h:102-118).
// X is a frame timeline (prior ring frames in ascending time, then fresh
// frame spectra), H the coefficient frames in ring order; both are split
// re/im float32 planes, the JAX layout.
//
// What bounds it on the card. At the offline render shape (C = 64,
// nout = 470, nparts = 256, bins = 512) the MAC is
// 8 * C * nout * nparts * bins ~ 31.5 GFLOP of FP32 (0.47 ms at 67
// TFLOP/s) against ~380 MB of planes read and written once (0.11 ms at
// 3.35 TB/s): bound by FP32 operations, and by how many FMAs each loaded
// element feeds. At the K = 8 chunked serving shape (nout = 8) the same
// planes are read for 1/59 of the work: bound by bytes, and by how many
// loads are in flight.
//
// What the design does about it. The TPU kernels keep shifted,
// column-0-adjusted h stacks resident in VMEM (chunk_mac) or stream
// 8-row-aligned tiles by double-buffered DMA (macflow); both are VMEM
// workarounds. Here the entry takes one of two routes, chosen by the
// caller from the shape (ops/cuda/slidemac.py slide_route):
//   - long timelines (1 x 1880, 16 x 470, 64 x 470): the scans' tiled MAC
//     (scan_mac.cuh mac_tile_kernel<H_LTI, TT>, plan (G, TT, Q) from
//     ops/cuda/streamstep.py mac_plan) on the split planes through a
//     MacIO. A CTA of G warps slides G * TT outputs x 32 bins of a channel
//     through registers and streams the partitions in stages of Q through
//     shared memory by cp.async, so each h and timeline element crosses L2
//     once per CTA and feeds G * TT outputs.
//   - short timelines (a K = 8 chunk: 64 channels x 8 outputs, too few
//     CTAs of the tiled or the per-thread grid to fill the card):
//     slide_mac_split_kernel<H_LTI>, one thread a bin and MAC_TT outputs
//     with the partitions split between `slices` q-slices of a CTA
//     (mac_rows_q, loads one partition ahead); the slices' sums meet in
//     shared memory and are added in slice order by one thread.
// Bin 0 multiplies componentwise (a warp-uniform select in the tile, its
// own instantiation in the split kernel). Any nparts >= 1, bins >= 1 and
// nout >= 1 are taken: rows past the timeline read as zero. No atomics:
// every sum is taken in a fixed order, so a launch is bitwise
// deterministic.

#include "scan_mac.cuh"   // the tiled MAC, mac_rows_q, MAC_TT, MAC_THREADS

namespace {

// Sizes and per-channel strides: channel c of x starts at c * rows * bins,
// of h at c * hrows * bins (LTI: hrows = nparts), of the outputs at
// c * nout * bins.
struct Mac {
    int C, rows, nparts, bins, nout;
};

// The TV sliding MAC. Replaces opencl_fft_tpu/ops/pallas/macflow.py
// _tv_kernel (wrapper macflow_tv :498) and _tv_batched_kernel
// (macflow_tv_batched :646). For channel c, output t < nout and bin k:
//   acc[c, t, k] = sum_{p < nparts} X[c, t+p, k] (*) H[c, hrow(t, p), k],
//   hrow(t, p) = t + nparts-1 - ((t - nparts+1 + p + phase) mod nparts),
// bin 0 componentwise and times b0. X and H are the input and coefficient
// frame timelines (row f + nparts-1 holds the frame of time f; rows
// [0, nparts-1) the pre-call ring contents in time order), phase the
// coefficient ring's (nparts-1 - wp2) mod nparts, shared by the channels.
// This is the TV scan's MAC (scan_mac.cuh) with X one row earlier:
// hrow(t, p) = t - ((t - wp2 + p) mod nparts) + nparts-1. So it runs that
// code: one thread per bin slides MAC_TT output rows of X through
// registers, and for nparts >= MAC_TT reads two H rows per p for all of
// them (H_TV_PAIR: the row changes only where the mod wraps, once in
// MAC_TT consecutive outputs), one per output below (H_TV). Where that
// grid is short (a K = 8 chunk), slide_mac_split_kernel splits the
// partitions between the threads of a CTA instead.
//
// What bounds it on the card: as the LTI MAC, FP32 operations at long
// timelines (8 C nout nparts bins; 1.97 GFLOP at 1 x 1880, nparts 256,
// bins 512) and bytes at short ones (a K = 8 chunk reads both timelines,
// 64 x 263 x 512 x 8 B each, for 8 outputs). The TPU kernel streams
// 8-row-aligned DMA tiles of the reversed X and of H, so it takes only
// phases = 0 (mod 8) and the JAX engine routes the others to XLA gathers;
// here every phase, nparts >= 1, bins and output count runs the kernel.
template <HMode MODE>
__global__ void __launch_bounds__(MAC_THREADS)
slide_mac_tv_kernel(Mac s, int hrows, int wp2, const float* __restrict__ xr,
                    const float* __restrict__ xi, const float* __restrict__ hr,
                    const float* __restrict__ hi, float b0, float* __restrict__ outr,
                    float* __restrict__ outi) {
    const int k = blockIdx.y * MAC_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const int t0 = blockIdx.x * MAC_TT;
    const size_t c = blockIdx.z, bins = s.bins;
    const size_t x0 = c * s.rows, h0 = c * hrows, o0 = c * s.nout;
    if (k == 0)
        mac_rows<true, MODE>(s.nout, s.rows, s.nparts, k, t0, wp2, xr, xi, bins, hr, hi, bins,
                             b0, outr, outi, bins, x0, h0, o0);
    else
        mac_rows<false, MODE>(s.nout, s.rows, s.nparts, k, t0, wp2, xr, xi, bins, hr, hi,
                              bins, b0, outr, outi, bins, x0, h0, o0);
}

// The sliding MAC (LTI: H_LTI, hrows = nparts; TV: H_TV or H_TV_PAIR) with
// the partitions split inside a CTA, for grids too short to fill the card
// (a K = 8 chunk: 256 CTAs of 128 threads, each walking 256 partitions with
// dependent loads at every one, reach 15% of the TV MAC's bytes bound and
// 19% of the LTI MAC's). `slices` q-slices work on the same MAC_THREADS bins x
// MAC_TT outputs: thread (slice, lane) takes partitions [q0, q1), q0 =
// slice * nparts / slices (some slices may be empty), through mac_rows_q.
// The partial sums then meet in shared memory ([2][slices][MAC_TT]
// [MAC_THREADS] floats) and each output is summed over the slices in slice
// order by one thread, so the result does not depend on timing (no
// atomics). X and H are read once from device memory; the grid is the
// unsplit kernel's.
constexpr int MAX_SLICES = 8;

template <HMode MODE>
__global__ void __launch_bounds__(MAC_THREADS * MAX_SLICES)
slide_mac_split_kernel(Mac s, int hrows, int wp2, int slices, const float* __restrict__ xr,
                       const float* __restrict__ xi, const float* __restrict__ hr,
                       const float* __restrict__ hi, float b0, float* __restrict__ outr,
                       float* __restrict__ outi) {
    extern __shared__ float part[];
    const int lane = threadIdx.x % MAC_THREADS, slice = threadIdx.x / MAC_THREADS;
    const int k = blockIdx.y * MAC_THREADS + lane;
    const int t0 = blockIdx.x * MAC_TT;
    const size_t c = blockIdx.z, bins = s.bins;
    const size_t x0 = c * s.rows, h0 = c * hrows, o0 = c * s.nout;
    const int q0 = slice * s.nparts / slices, q1 = (slice + 1) * s.nparts / slices;
    float ar[MAC_TT] = {}, ai[MAC_TT] = {};
    if (k == 0)
        mac_rows_q<true, MODE>(s.nout, s.rows, s.nparts, k, t0, wp2, q0, q1, xr, xi, bins, hr, hi,
                               bins, x0, h0, ar, ai);
    else if (k < s.bins)
        mac_rows_q<false, MODE>(s.nout, s.rows, s.nparts, k, t0, wp2, q0, q1, xr, xi, bins, hr,
                                hi, bins, x0, h0, ar, ai);
    float* pr = part;
    float* pi = part + slices * MAC_TT * MAC_THREADS;
#pragma unroll
    for (int j = 0; j < MAC_TT; ++j) {
        pr[(slice * MAC_TT + j) * MAC_THREADS + lane] = ar[j];
        pi[(slice * MAC_TT + j) * MAC_THREADS + lane] = ai[j];
    }
    __syncthreads();
    if (k >= s.bins) return;
    for (int j = slice; j < MAC_TT && t0 + j < s.nout; j += slices) {
        float sr = 0.f, si = 0.f;
        for (int u = 0; u < slices; ++u) {
            sr += pr[(u * MAC_TT + j) * MAC_THREADS + lane];
            si += pi[(u * MAC_TT + j) * MAC_THREADS + lane];
        }
        outr[(o0 + t0 + j) * bins + k] = k == 0 ? b0 * sr : sr;
        outi[(o0 + t0 + j) * bins + k] = k == 0 ? b0 * si : si;
    }
}

size_t split_granted[3][64];   // [HMode][device]

// The q-split kernel at `slices` slices a CTA, on the unsplit kernel's grid
// of MAC_TT outputs x MAC_THREADS bins x C.
template <HMode MODE>
cudaError_t launch_split(const Mac& s, int hrows, int wp2, int slices, const float* xr,
                         const float* xi, const float* hr, const float* hi, float b0,
                         float* outr, float* outi, int device, cudaStream_t st) {
    if (slices < 1 || slices > MAX_SLICES) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * 2 * slices * MAC_TT * MAC_THREADS;
    RETURN_IF_ERROR(allow_smem(slide_mac_split_kernel<MODE>, device, smem, split_granted[MODE]));
    slide_mac_split_kernel<MODE>
        <<<dim3(cdiv(s.nout, MAC_TT), cdiv(s.bins, MAC_THREADS), s.C), MAC_THREADS * slices, smem,
           st>>>(s, hrows, wp2, slices, xr, xi, hr, hi, b0, outr, outi);
    return cudaGetLastError();
}

}  // namespace

// acc[c, t] = sum_q x[c, t+q] (*) h[c, q] for t < nout, all C channels.
// x planes (C, rows, bins) (rows past the last window unread), h planes
// (C, nparts, bins), outputs (C, nout, bins); float32 device memory on
// `device`, each plane contiguous. The route (ops/cuda/slidemac.py
// slide_route chooses): slices in [1, MAX_SLICES] runs the q-split kernel
// with that many partition slices a CTA; slices = 0 the tiled MAC at
// `plan`, a host array of 4 ints (warps a CTA, outputs a thread, partitions
// a stage, ring rows: scan_mac.cuh MacPlan). Launches on `stream` without
// synchronising; returns the first CUDA error.
extern "C" int slide_mac_batched_f32(const float* xr, const float* xi, const float* hr,
                                     const float* hi, float* outr, float* outi, int C,
                                     int rows, int nparts, int bins, int nout, float b0,
                                     int slices, const int* plan, int device,
                                     void* stream_ptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Mac s{C, rows, nparts, bins, nout};
    cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
    if (slices > 0)
        return static_cast<int>(launch_split<H_LTI>(s, nparts, 0, slices, xr, xi, hr, hi, b0,
                                                    outr, outi, device, st));
    if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const size_t b = bins;
    const MacIO io{xr, xi, b, static_cast<size_t>(rows) * b, rows,
                   hr, hi, b, static_cast<size_t>(nparts) * b,
                   outr, outi, b, static_cast<size_t>(nout) * b};
    return static_cast<int>(launch_lti_tile(Scan{nout, C, nparts, bins},
                                            MacPlan{plan[0], plan[1], plan[2], plan[3]}, io, b0,
                                            device, st));
}

// The TV sliding MAC of every channel for t < nout: x planes (C, rows,
// bins) (rows >= nparts-1+nout; later rows unread), h planes (C, hrows,
// bins) (hrows >= nparts-1+nout), outputs (C, nout, bins); phase in
// [0, nparts). slices in [1, MAX_SLICES]: 1 runs slide_mac_tv_kernel,
// more slide_mac_split_kernel with that many partition slices a CTA
// (ops/cuda/slidemac.py tv_q_slices chooses). Float32 device memory on
// `device`, each plane contiguous. Launches on `stream` without
// synchronising; returns the first CUDA error.
extern "C" int slide_mac_tv_batched_f32(const float* xr, const float* xi, const float* hr,
                                        const float* hi, float* outr, float* outi, int C,
                                        int rows, int hrows, int nparts, int bins, int nout,
                                        int phase, float b0, int slices, int device,
                                        void* stream_ptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (slices < 1 || slices > MAX_SLICES) return static_cast<int>(cudaErrorInvalidValue);
    const Mac s{C, rows, nparts, bins, nout};
    const int wp2 = (nparts - 1 - phase) % nparts;
    const dim3 grid(cdiv(nout, MAC_TT), cdiv(bins, MAC_THREADS), C);
    cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
    if (slices > 1)
        return static_cast<int>(
            nparts >= MAC_TT
                ? launch_split<H_TV_PAIR>(s, hrows, wp2, slices, xr, xi, hr, hi, b0, outr, outi,
                                          device, st)
                : launch_split<H_TV>(s, hrows, wp2, slices, xr, xi, hr, hi, b0, outr, outi,
                                     device, st));
    if (nparts >= MAC_TT)
        slide_mac_tv_kernel<H_TV_PAIR><<<grid, MAC_THREADS, 0, st>>>(s, hrows, wp2, xr, xi, hr,
                                                                     hi, b0, outr, outi);
    else
        slide_mac_tv_kernel<H_TV><<<grid, MAC_THREADS, 0, st>>>(s, hrows, wp2, xr, xi, hr, hi,
                                                                b0, outr, outi);
    return static_cast<int>(cudaGetLastError());
}
