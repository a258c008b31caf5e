// Per-block partitioned-convolution steps on Hopper (sm_90a), for C channels
// at once (C = 1 is the single stream): the frequency-delay-line MAC over
// the doubled input ring, alone or fused with the inverse transform and the
// overlap-add, with or without the forward transform of the new block.
//
// Replaces five TPU kernels:
//   opencl_fft_tpu/ops/pallas/mac.py        _mac_kernel (spectral_mac :87)
//   opencl_fft_tpu/ops/pallas/blockstep.py  _blockstep_full_kernel
//                                           (block_step_fused :438)
//                                           _blockstep_fwd_kernel
//                                           (block_step_fwd_fused :343)
//                                           _blockstep_fwd_tv_kernel
//                                           (block_step_fwd_fused_tv :382)
//                                           _blockstep_kernel
//                                           (block_mac_unpack :484)
// For channel c, bin k, with window row q = doubled-ring row rp + q:
//   acc[c, k] = sum_{q < nparts} X[c, rp + q, k] (*) H[c, q, k]
// a complex product except at bin 0, the packed (DC/2, Nyq/2) pair, which
// multiplies componentwise and is scaled by b0 (cl_conv_kernels.h:102-118).
// block_step_fused then computes y = [acc_re | acc_im] @ wpost (the f64-built
// (2b, 2b) table of unpack + inverse DFT + deinterleave), out = (y[:b] +
// tail) / pts and new_tail = y[b:]. block_step_fwd_fused first computes the
// new block's frame F = block @ wfwd (the (pts, 2b) forward table): F
// replaces window row nparts-1 (ring slot wp = rp - 1 mod nparts, still
// stale in the given ring), and is written with the given ring into a NEW
// doubled ring at slots wp and wp + nparts (the given ring is not touched:
// the per-block functions return new state). The TV form transforms both
// operands as one 2-row product; the coefficient frame replaces H row wp2
// and is written with H into a new coefficient ring. block_mac_unpack
// returns z = unpack_inverse(acc) (ops/rfft.py): z[0] = (re + im, re - im),
// z[M/2] = acc[M/2] and every other bin k mixes acc[k] with
// acc[(M - k) mod M] and the twiddle exp(+i pi k / M), M = bins: the input
// of the half-size inverse FFT, for partitions whose dense post table is
// too large to build (pts > 2048).
//
// What bounds it on the card. At the headline shape (nparts 256, bins 512)
// one channel's MAC reads the 1 MiB window and the 1 MiB IR ring and does
// 8 * 256 * 512 ~ 1 MFLOP; the post product reads the 4 MiB wpost table,
// the forward product the 2 MiB wfwd table: ~2.5 us of bytes at 3.35 TB/s.
// At that size launch latency and the serial depth of each stage, not
// bytes, set the time. At 64 channels the window and IR ring are 134 MB and
// the new input ring that the fused step writes another 134 MB: bound by
// bytes (~80 us), with the tables read from L2.
//
// What the design does about it. The TPU kernels run each stage on one core
// over VMEM-resident planes. Here each stage is spread over the card:
//   1. fwd_kernel (fused step only): F = blocks (R*C, pts) @ wfwd, a GEMV
//      parallel over output columns (one warp's 32 lanes on 32 consecutive
//      columns of a table row, 16 warps on interleaved k) and over row tiles;
//      the warps' sums are added in warp order.
//   2. mac_kernel: one thread per (channel, bin, partition slice): the
//      partition range is cut into up to MAC_SLICES slices so that even one
//      channel's 512 bins fill the card; each thread sums its slice with q
//      ascending and stores a partial sum. The fused step's threads write
//      the new rings from the same loads: window row q covers ring slot
//      (rp + q) mod nparts once, and the slot's two doubled rows are written
//      from it.
//   3. reduce_kernel: the slices' partial sums added in slice order, bin 0
//      times b0.
//   4. post_ola_kernel: [acc_re | acc_im] @ wpost as the GEMV of stage 1,
//      with the overlap-add and the 1/pts folded into its store.
//   3'. reduce_unpack_kernel (block_mac_unpack, in place of 3 and 4): one
//      thread owns the bin pair (k, M - k), k <= M/2, because the unpack of
//      either bin reads both accumulators, which exist only after the slice
//      reduce. It reduces both bins as reduce_kernel does (so the
//      accumulator is spectral_mac's bit for bit) and writes both unpacked
//      bins, with each product and sum rounded on its own (no contraction
//      into FMA) as the plain unpack rounds them.
// No atomics anywhere: every sum is taken in a fixed order, so a call is
// bitwise deterministic and one channel's result does not depend on the
// others. block_step_fused and the fused steps run the same mac, reduce and
// post kernels, so given the same ring contents they give the same bits
// (a crossfade's outgoing path is bit-equal to its incoming path where the
// coefficients agree). Plain FP32 FMA, no TF32: the JAX tables run at
// Precision.HIGHEST. wgmma/TMA and one persistent launch for the whole step
// are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAC_THREADS = 128;   // bins per MAC block
constexpr int MAC_SLICES = 32;     // most partition slices per channel
constexpr int ROW_THREADS = 256;   // bins per reduce block
constexpr int GEMV_COLS = 32;      // output columns per GEMV block (one warp)
constexpr int GEMV_WARPS = 16;     // k-lanes per GEMV block
constexpr int GEMV_MT = 8;         // rows per GEMV block
constexpr int GEMV_THREADS = GEMV_COLS * GEMV_WARPS;

inline int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

#define BLOCKSTEP_RETURN_IF_ERROR(expr)                 \
    do {                                                \
        const cudaError_t err_ = (expr);                \
        if (err_ != cudaSuccess) return err_;           \
    } while (0)

// Sizes of one step: C channels, nparts partitions, bins == pts; the MAC
// window starts at doubled-ring row rp; the partition range is cut into
// `slices` slices of `qchunk` partitions.
struct Step {
    int C, nparts, bins, rp, qchunk, slices;
};

Step make_step(int C, int nparts, int bins, int rp) {
    const int qchunk = cdiv(nparts, MAC_SLICES);
    return Step{C, nparts, bins, rp, qchunk, cdiv(nparts, qchunk)};
}

// One GEMV tile: Y = A (M, K; row stride lda) @ B (K, N; row stride ldb) at
// rows m0 .. m0 + GEMV_MT - 1 and columns n0 .. n0 + GEMV_COLS - 1. Lane l of
// warp w sums k = w, w + GEMV_WARPS, ... ascending for column n0 + l; the
// warps' sums are then added in warp order. Thread t < GEMV_MT * GEMV_COLS
// gets Y[m0 + t / GEMV_COLS, n0 + t % GEMV_COLS] (0 outside the matrix);
// every thread of the block must call it.
__device__ __forceinline__ float gemv_tile(int M, int N, int K, const float* __restrict__ A,
                                           int lda, const float* __restrict__ B, int ldb,
                                           int m0, int n0) {
    __shared__ float red[GEMV_WARPS][GEMV_MT][GEMV_COLS];
    const int lane = threadIdx.x % GEMV_COLS, warp = threadIdx.x / GEMV_COLS;
    const int n = n0 + lane;
    float acc[GEMV_MT];
#pragma unroll
    for (int i = 0; i < GEMV_MT; ++i) acc[i] = 0.f;
    if (n < N) {
#pragma unroll 4
        for (int k = warp; k < K; k += GEMV_WARPS) {
            const float b = B[static_cast<size_t>(k) * ldb + n];
#pragma unroll
            for (int i = 0; i < GEMV_MT; ++i)
                if (m0 + i < M)
                    acc[i] = fmaf(A[static_cast<size_t>(m0 + i) * lda + k], b, acc[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < GEMV_MT; ++i) red[warp][i][lane] = acc[i];
    __syncthreads();
    float y = 0.f;
    const int t = threadIdx.x;
    if (t < GEMV_MT * GEMV_COLS) {
        const int i = t / GEMV_COLS, l = t % GEMV_COLS;
        for (int w = 0; w < GEMV_WARPS; ++w) y += red[w][i][l];
    }
    return y;
}

// F (M, 2*pts) = blocks (M, pts) @ wfwd (pts, 2*pts);
// grid (cdiv(2*pts, GEMV_COLS), cdiv(M, GEMV_MT))
__global__ void __launch_bounds__(GEMV_THREADS)
fwd_kernel(int M, int pts, const float* __restrict__ blocks, const float* __restrict__ wfwd,
           float* __restrict__ F) {
    const int b2 = 2 * pts;
    const int n0 = blockIdx.x * GEMV_COLS, m0 = blockIdx.y * GEMV_MT;
    const float y = gemv_tile(M, b2, pts, blocks, pts, wfwd, b2, m0, n0);
    const int t = threadIdx.x;
    if (t >= GEMV_MT * GEMV_COLS) return;
    const int m = m0 + t / GEMV_COLS, n = n0 + t % GEMV_COLS;
    if (m < M && n < b2) F[static_cast<size_t>(m) * b2 + n] = y;
}

// Partial MAC sums of channel c = blockIdx.z, slice blockIdx.y, bin k:
// part[c, slice] = [sum re | sum im] over the slice's partitions, q
// ascending (bin 0 componentwise, not yet times b0).
// x planes (C, 2*nparts, bins), h planes (C, nparts, bins). fx (row stride
// 2b per channel), when given, replaces window row nparts-1; fh, when given,
// replaces h row h_row. nxr/nxi (C, 2*nparts, bins), when given, receive the
// new doubled input ring, nhr/nhi (C, nparts, bins) the new coefficient ring.
// grid (cdiv(bins, MAC_THREADS), slices, C)
__global__ void __launch_bounds__(MAC_THREADS)
mac_kernel(Step s, const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ hr, const float* __restrict__ hi,
           const float* __restrict__ fx, const float* __restrict__ fh, int h_row,
           float* __restrict__ nxr, float* __restrict__ nxi, float* __restrict__ nhr,
           float* __restrict__ nhi, float* __restrict__ part) {
    const int k = blockIdx.x * MAC_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const int slice = blockIdx.y;
    const size_t c = blockIdx.z;
    const size_t bins = s.bins, np = s.nparts, b2 = 2 * bins;
    const size_t x0 = c * 2 * np * bins, h0 = c * np * bins;
    const int q0 = slice * s.qchunk;
    const int q1 = min(q0 + s.qchunk, s.nparts);
    const bool dc = k == 0;
    float ar = 0.f, ai = 0.f;
#pragma unroll 4
    for (int q = q0; q < q1; ++q) {
        const size_t row = s.rp + q;                    // < 2 * nparts
        float x_r, x_i;
        if (fx != nullptr && q == s.nparts - 1) {
            x_r = fx[c * b2 + k];
            x_i = fx[c * b2 + bins + k];
        } else {
            x_r = xr[x0 + row * bins + k];
            x_i = xi[x0 + row * bins + k];
        }
        if (nxr != nullptr) {
            const size_t slot = row >= np ? row - np : row;
            nxr[x0 + slot * bins + k] = x_r;
            nxi[x0 + slot * bins + k] = x_i;
            nxr[x0 + (slot + np) * bins + k] = x_r;
            nxi[x0 + (slot + np) * bins + k] = x_i;
        }
        float h_r, h_i;
        if (fh != nullptr && q == h_row) {
            h_r = fh[c * b2 + k];
            h_i = fh[c * b2 + bins + k];
        } else {
            h_r = hr[h0 + static_cast<size_t>(q) * bins + k];
            h_i = hi[h0 + static_cast<size_t>(q) * bins + k];
        }
        if (nhr != nullptr) {
            nhr[h0 + static_cast<size_t>(q) * bins + k] = h_r;
            nhi[h0 + static_cast<size_t>(q) * bins + k] = h_i;
        }
        if (dc) {              // packed (DC/2, Nyq/2) bin: componentwise
            ar = fmaf(x_r, h_r, ar);
            ai = fmaf(x_i, h_i, ai);
        } else {
            ar = fmaf(x_r, h_r, fmaf(-x_i, h_i, ar));
            ai = fmaf(x_r, h_i, fmaf(x_i, h_r, ai));
        }
    }
    float* p = part + (c * s.slices + slice) * b2;
    p[k] = ar;
    p[bins + k] = ai;
}

// acc[c, k] = sum over slices of part[c, slice, k] (slice order), bin 0
// times b0; re into outr[c * out_cs + k], im into outi[c * out_cs + k].
// grid (cdiv(bins, ROW_THREADS), C)
__global__ void __launch_bounds__(ROW_THREADS)
reduce_kernel(Step s, float b0, const float* __restrict__ part, float* __restrict__ outr,
              float* __restrict__ outi, int out_cs) {
    const int k = blockIdx.x * ROW_THREADS + threadIdx.x;
    if (k >= s.bins) return;
    const size_t c = blockIdx.y, b2 = 2 * static_cast<size_t>(s.bins);
    const float* p = part + c * s.slices * b2;
    float r = 0.f, i = 0.f;
    for (int sl = 0; sl < s.slices; ++sl) {
        r += p[sl * b2 + k];
        i += p[sl * b2 + s.bins + k];
    }
    if (k == 0) {
        r *= b0;
        i *= b0;
    }
    outr[c * out_cs + k] = r;
    outi[c * out_cs + k] = i;
}

// The slices' partial sums of bin k of one channel's part rows, added in
// slice order as reduce_kernel adds them; bin 0 times b0.
__device__ __forceinline__ void slice_sum(const Step& s, const float* __restrict__ p, int k,
                                          float b0, float& r, float& i) {
    const size_t b2 = 2 * static_cast<size_t>(s.bins);
    r = 0.f;
    i = 0.f;
    for (int sl = 0; sl < s.slices; ++sl) {
        r += p[sl * b2 + k];
        i += p[sl * b2 + s.bins + k];
    }
    if (k == 0) {
        r *= b0;
        i *= b0;
    }
}

// One generic bin of the inverse unpack (rfft.unpack_inverse): (re, im) the
// bin's accumulator, (fr, fi) its mirror's, (wr, wi) its twiddle.
__device__ __forceinline__ void unpack_bin(float re, float im, float fr, float fi, float wr,
                                           float wi, float* zr, float* zi) {
    const float er = __fmul_rn(0.5f, __fadd_rn(re, fr));
    const float ei = __fmul_rn(0.5f, __fsub_rn(im, fi));
    const float o_r = __fmul_rn(-0.5f, __fadd_rn(im, fi));
    const float o_i = __fmul_rn(0.5f, __fsub_rn(re, fr));
    *zr = __fadd_rn(er, __fsub_rn(__fmul_rn(wr, o_r), __fmul_rn(wi, o_i)));
    *zi = __fadd_rn(ei, __fadd_rn(__fmul_rn(wr, o_i), __fmul_rn(wi, o_r)));
}

// z[c] = unpack_inverse(acc[c]) from the MAC's partial sums: thread k in
// [0, M/2] owns bins k and j = (M - k) mod M. Bin 0 is (re + im, re - im);
// bin M/2 (k == M/2; for odd M the floor) passes through; every other bin is
// unpack_bin against its mirror. twr/twi (M,) the twiddle exp(+i pi k / M).
// grid (cdiv(M/2 + 1, ROW_THREADS), C)
__global__ void __launch_bounds__(ROW_THREADS)
reduce_unpack_kernel(Step s, float b0, const float* __restrict__ part,
                     const float* __restrict__ twr, const float* __restrict__ twi,
                     float* __restrict__ zr, float* __restrict__ zi) {
    const int m = s.bins, half = m / 2;
    const int k = blockIdx.x * ROW_THREADS + threadIdx.x;
    if (k > half) return;
    const size_t c = blockIdx.y;
    const float* p = part + c * s.slices * 2 * static_cast<size_t>(m);
    zr += c * m;
    zi += c * m;
    float ar, ai;
    slice_sum(s, p, k, b0, ar, ai);
    if (k == 0) {
        zr[0] = __fadd_rn(ar, ai);
        zi[0] = __fsub_rn(ar, ai);
        return;
    }
    const int j = m - k;
    float fr = ar, fi = ai;
    if (j != k) slice_sum(s, p, j, b0, fr, fi);
    if (k == half) {
        zr[k] = ar;
        zi[k] = ai;
    } else {
        unpack_bin(ar, ai, fr, fi, twr[k], twi[k], zr + k, zi + k);
    }
    if (j != k) unpack_bin(fr, fi, ar, ai, twr[j], twi[j], zr + j, zi + j);
}

// y = z (C, 2b) @ wpost (2b, 2b); out[c, n] = (y[c, n] + tail[c, n]) / pts
// for n < b, new_tail[c, n - b] = y[c, n] for n >= b.
// grid (cdiv(2b, GEMV_COLS), cdiv(C, GEMV_MT))
__global__ void __launch_bounds__(GEMV_THREADS)
post_ola_kernel(Step s, const float* __restrict__ z, const float* __restrict__ wpost,
                const float* __restrict__ tail, float inv_pts, float* __restrict__ out,
                float* __restrict__ new_tail) {
    const int bins = s.bins, b2 = 2 * bins;
    const int n0 = blockIdx.x * GEMV_COLS, m0 = blockIdx.y * GEMV_MT;
    const float y = gemv_tile(s.C, b2, b2, z, b2, wpost, b2, m0, n0);
    const int t = threadIdx.x;
    if (t >= GEMV_MT * GEMV_COLS) return;
    const int m = m0 + t / GEMV_COLS, n = n0 + t % GEMV_COLS;
    if (m >= s.C || n >= b2) return;
    const size_t ch = static_cast<size_t>(m) * bins;
    if (n < bins)
        out[ch + n] = (y + tail[ch + n]) * inv_pts;
    else
        new_tail[ch + n - bins] = y;
}

cudaError_t launch_mac(const Step& s, const float* xr, const float* xi, const float* hr,
                       const float* hi, const float* fx, const float* fh, int h_row,
                       float* nxr, float* nxi, float* nhr, float* nhi, float* part,
                       cudaStream_t st) {
    mac_kernel<<<dim3(cdiv(s.bins, MAC_THREADS), s.slices, s.C), MAC_THREADS, 0, st>>>(
        s, xr, xi, hr, hi, fx, fh, h_row, nxr, nxi, nhr, nhi, part);
    return cudaGetLastError();
}

cudaError_t launch_reduce(const Step& s, float b0, const float* part, float* outr,
                          float* outi, int out_cs, cudaStream_t st) {
    reduce_kernel<<<dim3(cdiv(s.bins, ROW_THREADS), s.C), ROW_THREADS, 0, st>>>(
        s, b0, part, outr, outi, out_cs);
    return cudaGetLastError();
}

// reduce into z (C, 2b) = [acc_re | acc_im], then the post product and OLA
cudaError_t launch_post(const Step& s, float b0, const float* part, float* z,
                        const float* wpost, const float* tail, float* out, float* new_tail,
                        cudaStream_t st) {
    BLOCKSTEP_RETURN_IF_ERROR(launch_reduce(s, b0, part, z, z + s.bins, 2 * s.bins, st));
    post_ola_kernel<<<dim3(cdiv(2 * s.bins, GEMV_COLS), cdiv(s.C, GEMV_MT)), GEMV_THREADS, 0,
                      st>>>(s, z, wpost, tail, 1.0f / static_cast<float>(s.bins), out,
                            new_tail);
    return cudaGetLastError();
}

// The fused step, LTI (R = 1) or TV (R = 2): blocks (R, C, pts) rows r*C + c.
cudaError_t fwd_step(int R, const float* blocks, const float* xr, const float* xi,
                     const float* hr, const float* hi, const float* wfwd, const float* wpost,
                     const float* tail, float* out, float* new_tail, float* nxr, float* nxi,
                     float* nhr, float* nhi, float* F, float* part, float* z, int C,
                     int nparts, int pts, int rp, int wp2, float b0, int device,
                     cudaStream_t st) {
    BLOCKSTEP_RETURN_IF_ERROR(cudaSetDevice(device));
    const Step s = make_step(C, nparts, pts, rp);
    fwd_kernel<<<dim3(cdiv(2 * pts, GEMV_COLS), cdiv(static_cast<long long>(R) * C, GEMV_MT)),
                 GEMV_THREADS, 0, st>>>(R * C, pts, blocks, wfwd, F);
    BLOCKSTEP_RETURN_IF_ERROR(cudaGetLastError());
    const float* fh = R == 2 ? F + static_cast<size_t>(C) * 2 * pts : nullptr;
    BLOCKSTEP_RETURN_IF_ERROR(launch_mac(s, xr, xi, hr, hi, F, fh, wp2, nxr, nxi, nhr, nhi,
                                         part, st));
    return launch_post(s, b0, part, z, wpost, tail, out, new_tail, st);
}

}  // namespace

// All pointers are float32 device memory on `device`, each plane
// contiguous: x planes (C, 2*nparts, bins), h planes (C, nparts, bins),
// tails and outputs (C, bins), bins == pts. rp in [0, nparts) is the window's
// first doubled-ring row. Scratch, allocated by the caller:
//   part (C, min(nparts, MAC_SLICES), 2*bins), z (C, 2*bins),
//   F (R*C, 2*bins) for the fused steps.
// Each entry launches on `stream` without synchronising and returns the
// first CUDA error. block_mac_unpack_f32 takes any nparts >= 1 and bins >= 2.

// acc planes (C, bins) = the window MAC at rp.
extern "C" int spectral_mac_f32(const float* xr, const float* xi, const float* hr,
                                const float* hi, float* accr, float* acci, float* part, int C,
                                int nparts, int bins, int rp, float b0, int device,
                                void* stream_ptr) {
    cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
    BLOCKSTEP_RETURN_IF_ERROR(cudaSetDevice(device));
    const Step s = make_step(C, nparts, bins, rp);
    BLOCKSTEP_RETURN_IF_ERROR(launch_mac(s, xr, xi, hr, hi, nullptr, nullptr, -1, nullptr,
                                         nullptr, nullptr, nullptr, part, st));
    return static_cast<int>(launch_reduce(s, b0, part, accr, acci, bins, st));
}

// out, new_tail (C, pts) = MAC at rp, post product and OLA with tail.
extern "C" int block_step_fused_f32(const float* xr, const float* xi, const float* hr,
                                    const float* hi, const float* wpost, const float* tail,
                                    float* out, float* new_tail, float* part, float* z, int C,
                                    int nparts, int pts, int rp, float b0, int device,
                                    void* stream_ptr) {
    cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
    BLOCKSTEP_RETURN_IF_ERROR(cudaSetDevice(device));
    const Step s = make_step(C, nparts, pts, rp);
    BLOCKSTEP_RETURN_IF_ERROR(launch_mac(s, xr, xi, hr, hi, nullptr, nullptr, -1, nullptr,
                                         nullptr, nullptr, nullptr, part, st));
    return static_cast<int>(launch_post(s, b0, part, z, wpost, tail, out, new_tail, st));
}

// LTI fused step: block (C, pts); the new block's frame at ring slot
// wp = (rp - 1) mod nparts in the new ring (nxr, nxi) (C, 2*nparts, bins).
extern "C" int block_step_fwd_fused_f32(const float* block, const float* xr, const float* xi,
                                        const float* hr, const float* hi, const float* wfwd,
                                        const float* wpost, const float* tail, float* out,
                                        float* new_tail, float* nxr, float* nxi, float* F,
                                        float* part, float* z, int C, int nparts, int pts,
                                        int rp, float b0, int device, void* stream_ptr) {
    return static_cast<int>(fwd_step(1, block, xr, xi, hr, hi, wfwd, wpost, tail, out,
                                     new_tail, nxr, nxi, nullptr, nullptr, F, part, z, C,
                                     nparts, pts, rp, -1, b0, device,
                                     static_cast<cudaStream_t>(stream_ptr)));
}

// TV fused step: blocks (2, C, pts), input then coefficient operand; the
// coefficient frame at h row wp2 of the new coefficient ring (nhr, nhi)
// (C, nparts, bins).
extern "C" int block_step_fwd_fused_tv_f32(const float* blocks, const float* xr,
                                           const float* xi, const float* hr, const float* hi,
                                           const float* wfwd, const float* wpost,
                                           const float* tail, float* out, float* new_tail,
                                           float* nxr, float* nxi, float* nhr, float* nhi,
                                           float* F, float* part, float* z, int C, int nparts,
                                           int pts, int rp, int wp2, float b0, int device,
                                           void* stream_ptr) {
    return static_cast<int>(fwd_step(2, blocks, xr, xi, hr, hi, wfwd, wpost, tail, out,
                                     new_tail, nxr, nxi, nhr, nhi, F, part, z, C, nparts, pts,
                                     rp, wp2, b0, device,
                                     static_cast<cudaStream_t>(stream_ptr)));
}

// z planes (C, bins) = unpack_inverse of the window MAC at rp; twr/twi
// (bins,) the twiddle exp(+i pi k / bins), built in float64 by the caller.
extern "C" int block_mac_unpack_f32(const float* xr, const float* xi, const float* hr,
                                    const float* hi, const float* twr, const float* twi,
                                    float* zr, float* zi, float* part, int C, int nparts,
                                    int bins, int rp, float b0, int device, void* stream_ptr) {
    cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
    BLOCKSTEP_RETURN_IF_ERROR(cudaSetDevice(device));
    const Step s = make_step(C, nparts, bins, rp);
    BLOCKSTEP_RETURN_IF_ERROR(launch_mac(s, xr, xi, hr, hi, nullptr, nullptr, -1, nullptr,
                                         nullptr, nullptr, nullptr, part, st));
    reduce_unpack_kernel<<<dim3(cdiv(bins / 2 + 1, ROW_THREADS), C), ROW_THREADS, 0, st>>>(
        s, b0, part, twr, twi, zr, zi);
    return static_cast<int>(cudaGetLastError());
}
