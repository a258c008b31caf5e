// Per-block partitioned-convolution steps on Hopper (sm_90a), for C channels
// at once (C = 1 is the single stream): the frequency-delay-line MAC over
// the doubled input ring, alone or with the inverse transform and the
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
// block_step_fused then computes y, the inverse real transform of acc
// (unpack + inverse DFT + deinterleave; the JAX kernel's product against
// the (2b, 2b) wpost table), out = (y[:b] + tail) / pts and new_tail =
// y[b:]. block_step_fwd_fused first computes the new block's frame F, the
// packed forward transform of the zero-padded block (the JAX kernel's
// product against the (pts, 2b) wfwd table): F replaces window row
// nparts-1 (ring slot wp = rp - 1 mod nparts, still stale in the given
// ring), and is written with the given ring into a NEW doubled ring at
// slots wp and wp + nparts (the given ring is not touched: the per-block
// functions return new state). The TV form transforms both operands; the
// coefficient frame replaces H row wp2 and is written with H into a new
// coefficient ring. block_mac_unpack returns z = unpack_inverse(acc)
// (ops/rfft.py): z[0] = (re + im, re - im), z[M/2] = acc[M/2] and every
// other bin k mixes acc[k] with acc[(M - k) mod M] and the twiddle
// exp(+i pi k / M), M = bins: the input of the half-size inverse FFT,
// where the per-block functions take that route (pts > 2048).
//
// What bounds it on the card. At the headline shape (nparts 256, bins 512)
// one channel's MAC reads the 1 MiB window and the 1 MiB IR ring and does
// 8 * 256 * 512 ~ 1 MFLOP, and the fused step writes a new 2 MiB ring; the
// transforms are 5 m log2 m operations each on a few KiB: ~1.5 us of bytes
// at 3.35 TB/s. At that size launch latency and the serial depth of each
// stage, not bytes, set the time. At 64 channels the window and IR ring are
// 134 MB and the new input ring that the fused step writes another 134 MB:
// bound by bytes (~80 us).
//
// What the design does about it. The TPU kernels run each stage on one core
// over VMEM-resident planes and both transforms as products against dense
// tables (6 MiB at pts 512, 96 MiB at 2048, more than the L2). Here a step
// is at most three launches, spread over the card, and reads no table but
// the transforms' twiddles and coefficient rows (a few KiB), and
// spectral_mac and block_mac_unpack are one launch each (4. below): #11 at
// one channel (nparts 255, bins 4096) reads 16.7 MB, ~5 us of bytes, and at
// that size two launches and a reduce over a few CTAs cost more than the
// bytes:
//   1. fft_fwd_kernel<log2 pts> (frame_fft.cuh, the scans' forward, fused
//      steps only): the frames of the R*C blocks (R = 2 operands in the TV
//      step) as m-point FFTs inside a CTA and the pack, into F (C, R, 2b).
//      A CTA takes 2^11 values (at least one row; rows past the last block
//      are zero), so that 128 threads share one block's pack.
//   2. mac_kernel: one thread per (channel, bin, partition slice): the
//      partition range is cut into up to MAC_SLICES slices so that even one
//      channel's 512 bins fill the card; each thread sums its slice with q
//      ascending and stores a partial sum. The fused step's threads write
//      the new rings from the same loads: window row q covers ring slot
//      (rp + q) mod nparts once, and the slot's two doubled rows are written
//      from it.
//   3. step_inv_kernel<log2 pts> (block_step_fused and the fused steps):
//      a CTA takes one channel: it adds each bin's slice partials in slice
//      order (bin 0 times b0; 8 slices' loads in flight a thread) into
//      shared memory, unpacks them with the inverse coefficient rows (one
//      thread a bin pair (k, m - k)), runs the unnormalized m-point inverse
//      FFT on the tile of fft_tile.cuh and stores y_j, deinterleaved, from
//      registers: j < m/2 is out = (y + tail) / pts, j >= m/2 the new
//      tail. One transform gives both halves: the second half of
//      IFFT(U(acc)) is the first half of IFFT(U(pm acc)), pm = (-1)^k,
//      which the scans' inverse folds in as the previous block's tail. The
//      channel's row is row 0 of a tile of up to 16 rows and 2^13 values,
//      the others zero: the slice partials (up to 32 slices of 2 m floats)
//      take more loads than one row's m / 16 threads could issue, and 16
//      rows give each bin a thread.
//   4. mac_cluster_kernel<UNPACK> (spectral_mac, block_mac_unpack: one
//      launch a call, no partial sums in device memory). A thread-block
//      cluster of P.cluster CTAs takes a tile of P.tile columns of one
//      channel; the partition range is cut into P.cluster * P.ways slices of
//      P.qchunk partitions, slice rank * P.ways + way to the thread group
//      `way` of CTA `rank`, each thread summing its slice of one column with
//      q ascending as mac_kernel does (8 partitions' loads issued at once).
//      Each CTA owns a share of the tile's columns: every thread stores its
//      partials into the owner's shared memory over distributed shared
//      memory, and after a cluster barrier each CTA adds its own columns'
//      partials in slice order from its own shared memory (bin 0 times b0)
//      and stores them. The stores wait on a split barrier, arrived at at
//      entry and waited on after the MAC, so every CTA of the cluster has
//      started before a peer touches its shared memory, and the wait
//      overlaps the MAC. Nothing is read across the cluster after the
//      second barrier, so no third one holds a CTA back before it exits.
//      spectral_mac's column u of tile t is bin t * P.tile + u.
//      block_mac_unpack's tile holds P.tile / 2 bin pairs: column u <
//      P.tile / 2 is bin k = t * P.tile / 2 + u <= M / 2 and column P.tile
//      / 2 + u its mirror (M - k) mod M (consecutive addresses in reverse
//      order, so a warp's loads still coalesce); a pair's owner holds both
//      accumulators on chip and unpacks them with each product and sum
//      rounded on its own (no contraction into FMA) as the plain unpack
//      rounds them. The plan (ops/cuda/mac.py mac_plan) depends on (nparts,
//      bins) only, and both kernels run the same MAC and slice-order sum, so
//      block_mac_unpack is unpack_inverse(spectral_mac) bit for bit and one
//      channel's bits do not depend on C.
// No atomics anywhere: every sum is taken in a fixed order, so a call is
// bitwise deterministic and one channel's result does not depend on the
// others. block_step_fused and the fused steps run the same mac and
// inverse kernels, so given the same ring contents they give the same bits
// (a crossfade's outgoing path is bit-equal to its incoming path where the
// coefficients agree). Plain FP32, no TF32. pts is a power of two in
// [2, 2^14] for the steps with a transform (the in-CTA transform's range).

#include <cooperative_groups.h>

#include "frame_fft.cuh"   // fft_fwd_kernel, kFwdLaunch, tile shapes; fft_tile.cuh, scan_mac.cuh

namespace cg = cooperative_groups;

namespace {

constexpr int MAC_SLICES = 32;     // most partition slices per channel (mac_kernel)
constexpr int SLICE_LOADS = 8;     // slice partials a step-inverse thread loads at once

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

// Partial MAC sums of channel c = blockIdx.z, slice blockIdx.y, bin k:
// part[c, slice] = [sum re | sum im] over the slice's partitions, q
// ascending (bin 0 componentwise, not yet times b0).
// x planes (C, 2*nparts, bins), h planes (C, nparts, bins). fx (channel
// stride f_cs), when given, replaces window row nparts-1; fh (the same
// stride), when given, replaces h row h_row. nxr/nxi (C, 2*nparts, bins),
// when given, receive the new doubled input ring, nhr/nhi (C, nparts, bins)
// the new coefficient ring.
// grid (cdiv(bins, MAC_THREADS), slices, C)
__global__ void __launch_bounds__(MAC_THREADS)
mac_kernel(Step s, const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ hr, const float* __restrict__ hi,
           const float* __restrict__ fx, const float* __restrict__ fh, size_t f_cs, int h_row,
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
            x_r = fx[c * f_cs + k];
            x_i = fx[c * f_cs + bins + k];
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
            h_r = fh[c * f_cs + k];
            h_i = fh[c * f_cs + bins + k];
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

// The plan of mac_cluster_kernel (ops/cuda/mac.py mac_plan): CTAs a
// cluster, thread groups (slices) a CTA, partitions a slice, columns a CTA.
struct ClusterPlan {
    int cluster, ways, qchunk, tile;
};

constexpr int CLUSTER_MAX = 8;         // the portable cluster size of Hopper
constexpr int CLUSTER_THREADS = 512;   // most threads a CTA: tile * ways

// The halves of a split cluster barrier: every thread of every CTA of the
// cluster arrives, and a wait returns once all have arrived (acquire
// semantics). The arrive publishes nothing (relaxed): it only tells the
// peers this CTA has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait;\n" : : : "memory");
}

// Whether mac_cluster_kernel takes plan p at (nparts, bins): the slices
// cover every partition (the cluster's last ones may be empty), a CTA has
// at most CLUSTER_THREADS threads and an even tile of whole warps.
bool cluster_plan_ok(const ClusterPlan& p, int nparts, int bins) {
    return nparts >= 1 && bins >= 1 && p.cluster >= 1 && p.cluster <= CLUSTER_MAX &&
           p.ways >= 1 && p.qchunk >= 1 && p.tile >= 32 && p.tile % 32 == 0 &&
           p.tile * p.ways <= CLUSTER_THREADS &&
           static_cast<long long>(p.cluster) * p.ways * p.qchunk >= nparts;
}

// One column's sum over partitions [q0, q1) of channel offsets x0 (doubled
// ring) and h0, bin k, q ascending: mac_kernel's arithmetic (bin 0
// componentwise). MAC_BATCH partitions' loads are issued before their FMAs.
constexpr int MAC_BATCH = 8;

template <bool DC>
__device__ __forceinline__ void mac_slice(const float* __restrict__ xr,
                                          const float* __restrict__ xi,
                                          const float* __restrict__ hr,
                                          const float* __restrict__ hi, size_t bins, int q0,
                                          int q1, float& ar, float& ai) {
    for (int qb = q0; qb < q1; qb += MAC_BATCH) {
        float x_r[MAC_BATCH], x_i[MAC_BATCH], h_r[MAC_BATCH], h_i[MAC_BATCH];
#pragma unroll
        for (int u = 0; u < MAC_BATCH; ++u) {
            if (qb + u < q1) {
                const size_t o = static_cast<size_t>(qb + u) * bins;
                x_r[u] = xr[o];
                x_i[u] = xi[o];
                h_r[u] = hr[o];
                h_i[u] = hi[o];
            }
        }
#pragma unroll
        for (int u = 0; u < MAC_BATCH; ++u) {
            if (qb + u < q1) {
                if (DC) {
                    ar = fmaf(x_r[u], h_r[u], ar);
                    ai = fmaf(x_i[u], h_i[u], ai);
                } else {
                    ar = fmaf(x_r[u], h_r[u], fmaf(-x_i[u], h_i[u], ar));
                    ai = fmaf(x_r[u], h_i[u], fmaf(x_i[u], h_r[u], ai));
                }
            }
        }
    }
}

// The slice-order sum of one value's partials in this CTA's shared memory:
// slice sl at part[sl * stride + off], sl < nslices.
__device__ __forceinline__ float slice_order_sum(const float* part, int nslices, int stride,
                                                 int off) {
    float r = 0.f;
#pragma unroll 8
    for (int sl = 0; sl < nslices; ++sl) r += part[sl * stride + off];
    return r;
}

// acc = the window MAC at rp (at *rp_at where rp_at is not null: a CUDA
// graph's replay reads the pointer of the replay) of channel c = blockIdx.y
// (UNPACK false:
// outr/outi (C, bins) = acc) or z = unpack_inverse(acc) (UNPACK true:
// outr/outi (C, M) = z, M = bins; twr/twi (M,) exp(+i pi k / M)). A cluster
// of p.cluster CTAs takes column tile blockIdx.x / p.cluster. CTA `rank`
// owns `per` of the tile's columns (UNPACK: pairs, each a bin and its
// mirror): once every CTA of the cluster has started (the split barrier
// arrived at on entry, waited on after the MAC), every thread stores its
// slice's partials of its column into the owner's shared memory
// (distributed shared memory), at part[(slice * V + v) * per + slot], V = 2
// values a column (re, im) or 4 a pair (the bin's re, im, the mirror's re,
// im); after cluster.sync() each CTA sums its own columns in slice order
// from its own shared memory, so no CTA reads a peer and none waits on a
// third barrier before it exits.
// Dynamic shared memory: p.cluster * p.ways * V * per floats.
// grid (tiles * p.cluster, C), cluster (p.cluster), block p.tile * p.ways
template <bool UNPACK>
__global__ void __launch_bounds__(CLUSTER_THREADS)
mac_cluster_kernel(ClusterPlan p, int nparts, int bins, int rp, const int* __restrict__ rp_at,
                   float b0, const float* __restrict__ xr, const float* __restrict__ xi,
                   const float* __restrict__ hr, const float* __restrict__ hi,
                   const float* __restrict__ twr, const float* __restrict__ twi,
                   float* __restrict__ outr, float* __restrict__ outi) {
    extern __shared__ float part[];
    cluster_arrive_relaxed();           // this CTA has started
    if (rp_at != nullptr) rp = __ldg(rp_at);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int tile = blockIdx.x / p.cluster, T = p.tile, pairs = T / 2;
    const int col = threadIdx.x % T, slice = rank * p.ways + threadIdx.x / T;
    const int m = bins, half = m / 2;
    const size_t c = blockIdx.y, np = nparts;
    constexpr int V = UNPACK ? 4 : 2;
    const int per = cdiv(UNPACK ? pairs : T, p.cluster);
    // the column's bin, whether the tile has it, and where its owner keeps
    // its partials: column cu of the owned ones, value v0 (re) and v0 + 1
    const bool mirror = UNPACK && col >= pairs;
    const int cu = mirror ? col - pairs : col, v0 = mirror ? 2 : 0;
    const int kk = tile * (UNPACK ? pairs : T) + cu;
    const int k = mirror && kk != 0 ? m - kk : kk;
    const bool live = UNPACK ? kk <= half : kk < m;
    const int q0 = slice * p.qchunk, q1 = min(q0 + p.qchunk, nparts);
    float ar = 0.f, ai = 0.f;
    if (live) {
        const size_t x0 = (c * 2 * np + rp) * m + k, h0 = c * np * m + k;
        if (k == 0)
            mac_slice<true>(xr + x0, xi + x0, hr + h0, hi + h0, m, q0, q1, ar, ai);
        else
            mac_slice<false>(xr + x0, xi + x0, hr + h0, hi + h0, m, q0, q1, ar, ai);
    }
    cluster_wait();                     // every CTA of the cluster has started
    float* dst = cluster.map_shared_rank(part, cu / per) + (slice * V + v0) * per + cu % per;
    dst[0] = ar;
    dst[per] = ai;
    cluster.sync();                     // every slice's partials are with their owners
    const int nslices = cdiv(nparts, p.qchunk), stride = V * per;
    if (!UNPACK) {
        for (int i = threadIdx.x; i < 2 * per; i += blockDim.x) {
            const int comp = i / per, slot = i % per, kb = tile * T + rank * per + slot;
            if (rank * per + slot >= T || kb >= m) continue;
            float r = slice_order_sum(part, nslices, stride, comp * per + slot);
            if (kb == 0) r *= b0;
            (comp ? outi : outr)[c * m + kb] = r;
        }
        return;
    }
    float* zr = outr + c * m;
    float* zi = outi + c * m;
    for (int slot = threadIdx.x; slot < per; slot += blockDim.x) {
        const int u = rank * per + slot, kp = tile * pairs + u;
        if (u >= pairs || kp > half) continue;
        float a_r = slice_order_sum(part, nslices, stride, slot);
        float a_i = slice_order_sum(part, nslices, stride, per + slot);
        if (kp == 0) {
            a_r *= b0;
            a_i *= b0;
            zr[0] = __fadd_rn(a_r, a_i);
            zi[0] = __fsub_rn(a_r, a_i);
            continue;
        }
        const int j = m - kp;
        float f_r = a_r, f_i = a_i;
        if (j != kp) {
            f_r = slice_order_sum(part, nslices, stride, 2 * per + slot);
            f_i = slice_order_sum(part, nslices, stride, 3 * per + slot);
        }
        if (kp == half) {
            zr[kp] = a_r;
            zi[kp] = a_i;
        } else {
            unpack_bin(a_r, a_i, f_r, f_i, twr[kp], twi[kp], zr + kp, zi + kp);
        }
        if (j != kp) unpack_bin(f_r, f_i, a_r, a_i, twr[j], twi[j], zr + j, zi + j);
    }
}

// The launch of mac_cluster_kernel<UNPACK> for C channels at plan p.
template <bool UNPACK>
cudaError_t launch_mac_cluster(const ClusterPlan& p, int C, int nparts, int bins, int rp,
                               const int* rp_at, float b0, const float* xr, const float* xi,
                               const float* hr,
                               const float* hi, const float* twr, const float* twi,
                               float* outr, float* outi, cudaStream_t st) {
    if (!cluster_plan_ok(p, nparts, bins) || C < 1 || (UNPACK && bins < 2))
        return cudaErrorInvalidValue;
    const int tiles = UNPACK ? cdiv(bins / 2 + 1, p.tile / 2) : cdiv(bins, p.tile);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(tiles * p.cluster), static_cast<unsigned>(C));
    cfg.blockDim = dim3(static_cast<unsigned>(p.tile * p.ways));
    cfg.dynamicSmemBytes = sizeof(float) * p.cluster * p.ways * (UNPACK ? 4 : 2) *
                           cdiv(UNPACK ? p.tile / 2 : p.tile, p.cluster);
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = static_cast<unsigned>(p.cluster);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    RETURN_IF_ERROR(cudaLaunchKernelEx(&cfg, mac_cluster_kernel<UNPACK>, p, nparts, bins, rp,
                                       rp_at, b0, xr, xi, hr, hi, twr, twi, outr, outi));
    return cudaGetLastError();
}

// The step's inverse for channel c = blockIdx.x, on row 0 of a tile of
// B = 2^log_b rows of m = 2^LOG_L (the other rows are zero):
//   1. acc[c, k] = the slices' partials of part (C, slices, 2m) added in
//      slice order, bin 0 times b0, into the tile at (0, k);
//   2. in place, one thread a bin pair (k, m - k): U(acc) with the inverse
//      coefficient rows [a1, b1, na2, nb2, c1, d1, nc2, nd2] (8, m):
//      A = ar a1 + ai b1, Bv = ar na2 + ai nb2, D, E likewise,
//      U_k = (A_k + Bv_(m-k), D_k + E_(m-k));
//   3. y = IFFT_m(U) unnormalized (tw: the pass table of m, sign +1):
//      out[c, 2j + i] = (y_j + tail[c, 2j + i]) * inv_pts for j < m/2 (i = 0
//      the real part, 1 the imaginary), new_tail[c, 2j - m + i] = y_j
//      above.
template <int LOG_L>
__global__ void __launch_bounds__(tile_threads<LOG_L>(), LOG_L == BIG_LOG2 ? 1 : MIN_BLOCKS)
step_inv_kernel(Step s, float b0, const float* __restrict__ part, const float2* __restrict__ tw,
                const float* __restrict__ icoef, const float* __restrict__ tail, float inv_pts,
                float* __restrict__ out, float* __restrict__ new_tail, int log_b) {
    constexpr int log_l = LOG_L;
    extern __shared__ float smem[];
    const Layout<false> lay{log_l, log_b, row_stride(log_l)};
    const int m = 1 << log_l, half = m >> 1;
    float* sr = smem;
    float* si = smem + (1 << log_b) * lay.S;
    const size_t c = blockIdx.x, b2 = 2 * static_cast<size_t>(m);
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
        const float* p = part + c * s.slices * b2 + k;
        float r = 0.f, i = 0.f;
        for (int s0 = 0; s0 < s.slices; s0 += SLICE_LOADS) {
            float vr[SLICE_LOADS], vi[SLICE_LOADS];
#pragma unroll
            for (int u = 0; u < SLICE_LOADS; ++u) {
                const bool in = s0 + u < s.slices;
                vr[u] = in ? p[(s0 + u) * b2] : 0.f;
                vi[u] = in ? p[(s0 + u) * b2 + m] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < SLICE_LOADS; ++u) {
                if (s0 + u < s.slices) {
                    r += vr[u];
                    i += vi[u];
                }
            }
        }
        if (k == 0) {
            r *= b0;
            i *= b0;
        }
        sr[lay.smem(0, k)] = r;
        si[lay.smem(0, k)] = i;
    }
    __syncthreads();
    for (int k = threadIdx.x; k <= half; k += blockDim.x) {
        const int mk = (m - k) & (m - 1);
        float a[2], bv[2], d[2], ee[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int j = u ? mk : k;
            const float wr = sr[lay.smem(0, j)], wi = si[lay.smem(0, j)];
            a[u] = wr * __ldg(icoef + j) + wi * __ldg(icoef + m + j);
            bv[u] = wr * __ldg(icoef + 2 * m + j) + wi * __ldg(icoef + 3 * m + j);
            d[u] = wr * __ldg(icoef + 4 * m + j) + wi * __ldg(icoef + 5 * m + j);
            ee[u] = wr * __ldg(icoef + 6 * m + j) + wi * __ldg(icoef + 7 * m + j);
        }
        sr[lay.smem(0, k)] = a[0] + bv[1];
        si[lay.smem(0, k)] = d[0] + ee[1];
        if (mk != k) {
            sr[lay.smem(0, mk)] = a[1] + bv[0];
            si[lay.smem(0, mk)] = d[1] + ee[0];
        }
    }
    __syncthreads();
    auto sload = [&](int b, int q, float& re, float& im) {
        re = b == 0 ? sr[lay.smem(0, q)] : 0.f;
        im = b == 0 ? si[lay.smem(0, q)] : 0.f;
    };
    auto gstore = [&](int b, int j, float re, float im) {
        if (b != 0) return;
        const size_t cm = c * m;
        if (j < half) {
            out[cm + 2 * j] = (re + tail[cm + 2 * j]) * inv_pts;
            out[cm + 2 * j + 1] = (im + tail[cm + 2 * j + 1]) * inv_pts;
        } else {
            new_tail[cm + 2 * j - m] = re;
            new_tail[cm + 2 * j - m + 1] = im;
        }
    };
    fft_tile(lay, sr, si, sload, gstore, NoPre{}, false, tw, +1, true);
}

size_t inv_granted[BIG_LOG2 + 1][64];   // [log2 m][device]

// The launch of step_inv_kernel<LOG_L>: a CTA a channel, 2^log_b tile rows.
template <int LOG_L>
cudaError_t launch_step_inv(const Step& s, float b0, const float* part, const float2* tw,
                            const float* icoef, const float* tail, float* out, float* new_tail,
                            int log_b, int device, cudaStream_t st) {
    const TileShape g = tile_shape(LOG_L, log_b);
    RETURN_IF_ERROR(allow_smem(step_inv_kernel<LOG_L>, device, g.smem, inv_granted[LOG_L]));
    step_inv_kernel<LOG_L><<<s.C, g.threads, g.smem, st>>>(
        s, b0, part, tw, icoef, tail, 1.0f / static_cast<float>(s.bins), out, new_tail, log_b);
    return cudaGetLastError();
}

using StepInvLaunch = decltype(&launch_step_inv<1>);

template <int... L>
constexpr std::array<StepInvLaunch, sizeof...(L)> step_inv_launches(
    std::integer_sequence<int, L...>) {
    return {&launch_step_inv<L + 1>...};
}

// entry log2 m - 1: the launch at m = 2^1 .. 2^14
constexpr auto kStepInv = step_inv_launches(std::make_integer_sequence<int, BIG_LOG2>{});

cudaError_t launch_step_mac(const Step& s, const float* xr, const float* xi, const float* hr,
                            const float* hi, const float* fx, const float* fh, size_t f_cs,
                            int h_row, float* nxr, float* nxi, float* nhr, float* nhi,
                            float* part, cudaStream_t st) {
    mac_kernel<<<dim3(cdiv(s.bins, MAC_THREADS), s.slices, s.C), MAC_THREADS, 0, st>>>(
        s, xr, xi, hr, hi, fx, fh, f_cs, h_row, nxr, nxi, nhr, nhi, part);
    return cudaGetLastError();
}

// The transform plan of a step at pts, as the caller gives it: log2 rows
// a CTA of the forward tile (fwd_log_b, -1 for none) and of the inverse
// tile; false where pts is not a power of two in [2, 2^14] or a tile is not
// one the kernels take.
bool step_plan_ok(int pts, int fwd_log_b, int inv_log_b) {
    if (pts < 2 || (pts & (pts - 1)) != 0 || pts > (1 << BIG_LOG2)) return false;
    const int log_l = ilog2(pts);
    return (fwd_log_b < 0 || tile_ok(log_l, fwd_log_b)) && tile_ok(log_l, inv_log_b);
}

// The MAC over the ring (with the fused steps' frames F and new rings) and
// the inverse into out / new_tail.
cudaError_t mac_inverse(const Step& s, const float* xr, const float* xi, const float* hr,
                        const float* hi, const float* fx, const float* fh, size_t f_cs,
                        int h_row, float* nxr, float* nxi, float* nhr, float* nhi, float* part,
                        float b0, const float* twi, const float* icoef, const float* tail,
                        float* out, float* new_tail, int inv_log_b, int device,
                        cudaStream_t st) {
    RETURN_IF_ERROR(launch_step_mac(s, xr, xi, hr, hi, fx, fh, f_cs, h_row, nxr, nxi, nhr, nhi,
                                    part, st));
    return kStepInv[ilog2(s.bins) - 1](s, b0, part, reinterpret_cast<const float2*>(twi), icoef,
                                       tail, out, new_tail, inv_log_b, device, st);
}

// The fused step, LTI (R = 1) or TV (R = 2): blocks (R, C, pts) rows r*C + c
// (8-byte aligned), frames into F (C, R, 2*pts).
cudaError_t fwd_step(int R, const float* blocks, const float* xr, const float* xi,
                     const float* hr, const float* hi, const float* twf, const float* fcoef,
                     const float* twi, const float* icoef, const float* tail, float* out,
                     float* new_tail, float* nxr, float* nxi, float* nhr, float* nhi, float* F,
                     float* part, int C, int nparts, int pts, int rp, int wp2, int fwd_log_b,
                     int inv_log_b, float b0, int device, cudaStream_t st) {
    RETURN_IF_ERROR(cudaSetDevice(device));
    if (fwd_log_b < 0 || !step_plan_ok(pts, fwd_log_b, inv_log_b)) return cudaErrorInvalidValue;
    const int log_l = ilog2(pts);
    const TileShape g = tile_shape(log_l, fwd_log_b);
    const unsigned ctas = static_cast<unsigned>(cdiv(static_cast<long long>(R) * C,
                                                     1LL << fwd_log_b));
    const size_t f_cs = static_cast<size_t>(R) * 2 * pts;
    RETURN_IF_ERROR(kFwdLaunch[log_l - 1](Scan{R, C, nparts, pts}, 0, blocks,
                                          reinterpret_cast<const float2*>(twf), fcoef, F, f_cs,
                                          g, ctas, device, st));
    return mac_inverse(make_step(C, nparts, pts, rp), xr, xi, hr, hi, F,
                       R == 2 ? F + 2 * pts : nullptr, f_cs, wp2, nxr, nxi, nhr, nhi, part, b0,
                       twi, icoef, tail, out, new_tail, inv_log_b, device, st);
}

}  // namespace

// All pointers are float32 device memory on `device`, each plane
// contiguous: x planes (C, 2*nparts, bins), h planes (C, nparts, bins),
// tails and outputs (C, bins), bins == pts. rp in [0, nparts) is the window's
// first doubled-ring row. Scratch of the steps, allocated by the caller:
//   part (C, min(nparts, MAC_SLICES), 2*bins), F (C, R, 2*bins) for the
//   fused steps (R operands); spectral_mac_f32 and block_mac_unpack_f32
//   take none.
// The steps with a transform take a power-of-two pts in [2, 2^14], the
// transforms' tables (ops/cuda/blockstep.py): twf / twi the pass tables of
// pts for sign -1 / +1 (ops/cuda/vmemfft.py pass_twiddle_np), fcoef / icoef
// the forward / inverse coefficient rows (8, pts) (ops/cuda/tables.py
// _coef_stacks_np), and the plan: fwd_log_b / inv_log_b log2 rows a CTA of
// the forward / inverse tiles (ops/cuda/blockstep.py step_plan).
// Each entry launches on `stream` without synchronising and returns the
// first CUDA error. block_mac_unpack_f32 takes any nparts >= 1 and bins >= 2.

// acc planes (C, bins) = the window MAC at rp, one mac_cluster_kernel
// launch at the plan (cluster, ways, qchunk, tile) of ops/cuda/mac.py
// mac_plan.
extern "C" int spectral_mac_f32(const float* xr, const float* xi, const float* hr,
                                const float* hi, float* accr, float* acci, int C, int nparts,
                                int bins, int rp, int cluster, int ways, int qchunk, int tile,
                                float b0, int device, void* stream_ptr) {
    RETURN_IF_ERROR(cudaSetDevice(device));
    return static_cast<int>(launch_mac_cluster<false>(
        ClusterPlan{cluster, ways, qchunk, tile}, C, nparts, bins, rp, nullptr, b0, xr, xi, hr,
        hi, nullptr, nullptr, accr, acci, static_cast<cudaStream_t>(stream_ptr)));
}

// out, new_tail (C, pts) = MAC at rp, inverse transform and OLA with tail.
extern "C" int block_step_fused_f32(const float* xr, const float* xi, const float* hr,
                                    const float* hi, const float* twi, const float* icoef,
                                    const float* tail, float* out, float* new_tail, float* part,
                                    int C, int nparts, int pts, int rp, int inv_log_b, float b0,
                                    int device, void* stream_ptr) {
    RETURN_IF_ERROR(cudaSetDevice(device));
    if (!step_plan_ok(pts, -1, inv_log_b)) return cudaErrorInvalidValue;
    return static_cast<int>(mac_inverse(make_step(C, nparts, pts, rp), xr, xi, hr, hi, nullptr,
                                        nullptr, 0, -1, nullptr, nullptr, nullptr, nullptr, part,
                                        b0, twi, icoef, tail, out, new_tail, inv_log_b, device,
                                        static_cast<cudaStream_t>(stream_ptr)));
}

// LTI fused step: block (C, pts); the new block's frame at ring slot
// wp = (rp - 1) mod nparts in the new ring (nxr, nxi) (C, 2*nparts, bins).
extern "C" int block_step_fwd_fused_f32(const float* block, const float* xr, const float* xi,
                                        const float* hr, const float* hi, const float* twf,
                                        const float* fcoef, const float* twi,
                                        const float* icoef, const float* tail, float* out,
                                        float* new_tail, float* nxr, float* nxi, float* F,
                                        float* part, int C, int nparts, int pts, int rp,
                                        int fwd_log_b, int inv_log_b, float b0, int device,
                                        void* stream_ptr) {
    return static_cast<int>(fwd_step(1, block, xr, xi, hr, hi, twf, fcoef, twi, icoef, tail,
                                     out, new_tail, nxr, nxi, nullptr, nullptr, F, part, C,
                                     nparts, pts, rp, -1, fwd_log_b, inv_log_b, b0, device,
                                     static_cast<cudaStream_t>(stream_ptr)));
}

// TV fused step: blocks (2, C, pts), input then coefficient operand; the
// coefficient frame at h row wp2 of the new coefficient ring (nhr, nhi)
// (C, nparts, bins).
extern "C" int block_step_fwd_fused_tv_f32(const float* blocks, const float* xr,
                                           const float* xi, const float* hr, const float* hi,
                                           const float* twf, const float* fcoef,
                                           const float* twi, const float* icoef,
                                           const float* tail, float* out, float* new_tail,
                                           float* nxr, float* nxi, float* nhr, float* nhi,
                                           float* F, float* part, int C, int nparts, int pts,
                                           int rp, int wp2, int fwd_log_b, int inv_log_b,
                                           float b0, int device, void* stream_ptr) {
    return static_cast<int>(fwd_step(2, blocks, xr, xi, hr, hi, twf, fcoef, twi, icoef, tail,
                                     out, new_tail, nxr, nxi, nhr, nhi, F, part, C, nparts, pts,
                                     rp, wp2, fwd_log_b, inv_log_b, b0, device,
                                     static_cast<cudaStream_t>(stream_ptr)));
}

// z planes (C, bins) = unpack_inverse of the window MAC at rp; twr/twi
// (bins,) the twiddle exp(+i pi k / bins), built in float64 by the caller;
// one mac_cluster_kernel launch at spectral_mac_f32's plan. rp_at, where
// not null, is a device int in [0, nparts) that the kernel reads in rp's
// place when it runs (the per-block step's graph, ops/pconv.py StepGraph).
extern "C" int block_mac_unpack_f32(const float* xr, const float* xi, const float* hr,
                                    const float* hi, const float* twr, const float* twi,
                                    float* zr, float* zi, const int* rp_at, int C, int nparts,
                                    int bins, int rp, int cluster, int ways, int qchunk,
                                    int tile, float b0, int device, void* stream_ptr) {
    RETURN_IF_ERROR(cudaSetDevice(device));
    return static_cast<int>(launch_mac_cluster<true>(
        ClusterPlan{cluster, ways, qchunk, tile}, C, nparts, bins, rp, rp_at, b0, xr, xi, hr,
        hi, twr, twi, zr, zi, static_cast<cudaStream_t>(stream_ptr)));
}
