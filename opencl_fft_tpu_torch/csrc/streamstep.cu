// Whole-scan partitioned convolution on Hopper (sm_90a): LTI and
// time-varying (TV), for C channels at once (C = 1 is the single-channel
// scan), with the block transforms as FFTs inside the kernels.
//
// Replaces the TPU kernels of opencl_fft_tpu/ops/pallas/streamstep.py
// (_stream_kernel, wrapper stream_steps_fused; _stream_tv_kernel,
// stream_steps_fused_tv; _stream_batched_kernel :447,
// stream_steps_fused_batched; _stream_batched_tv_kernel :607,
// stream_steps_fused_batched_tv) and of ops/pallas/splitstep.py
// (_split_stream_kernel, stream_steps_fused_split :367;
// _split_stream_tv_kernel, stream_steps_fused_split_tv :493). They compute one function: for every
// input block t of every channel c, the forward rFFT of the zero-padded
// block, a one-frame slide of the channel's spectral window, the
// frequency-delay-line complex MAC against the channel's IR spectra (bin 0
// componentwise, scaled by b0), the inverse transform and the overlap-add
// with the channel's tail, divided by pts; in the TV scan the IR spectra
// are a ring too, block t's coefficient frame written at slot (wp2_c - t)
// mod nparts before its MAC. streamstep.py's kernels take both transform
// chains as dense DFT products against (pts, 2 pts) and (2 pts, 2 pts)
// tables, ops/pallas/splitstep.py's factor them through one (m, m) cos/sin
// table (m = pts = bins; its fwd_ref / inv_ref). Here each block's chain
// is the same function computed by an m-point complex FFT:
//   forward: the zero-padded 2m-sample frame of block x is the half-size
//     sequence z_j = x_2j + i x_2j+1 (nonzero for j < m/2); Z = FFT_m(z)
//     (sign -1), then the pack: packed bin k from Z_k and Z_(m-k) through
//     the 8 forward coefficient rows (ops/cuda/tables.py _coef_stacks_np):
//       re_k = Zr_k a1 + Zr_(m-k) a2 + Zi_k b1 + Zi_(m-k) b2, im_k likewise
//       from c1, c2, d1, d2;
//   inverse with the overlap-add folded in: output row t (t = 0..nb) is
//     the unpack U of w = acc[t] + pm acc[t-1] (pm = (-1)^k commutes with
//     U, since (m-k) has k's parity; acc[-1] = acc[nb] = 0), with the
//     inverse coefficient rows [a1, b1, na2, nb2, c1, d1, nc2, nd2]:
//       A = wr a1 + wi b1, Bv = wr na2 + wi nb2, D, E likewise,
//       U_k = (A_k + Bv_(m-k), D_k + E_(m-k));
//     y = IFFT_m(U) unnormalized (sign +1); its first m/2 values are
//     out1[t] + out2[t-1] deinterleaved (out[2j] = Re y_j, out[2j+1] =
//     Im y_j); the carried tail is added at t = 0 and the row divided by
//     pts; row nb is the final tail out2[nb-1]. One transform a row, nb+1
//     a channel.
//
// What bounds it on the card. At the 64-channel serving shape (pts 512, a
// 2^17-tap IR: nparts 256, 470 blocks) the MAC is 8 C nb nparts bins = 31.5
// GFLOP and the transforms 5 m log2 m a block each way (1.6 GFLOP in all,
// the LTI scan): 0.49 ms at 67 TFLOP/s, where the blocks, windows, IR planes
// and outputs (~0.3 GB) take 0.09 ms. At pts 4096 with a 2^20-tap IR and
// 470 blocks the same holds (3.94 + 0.25 GFLOP, ~17 MB). So the MAC bounds
// it: the transforms move each frame through device memory once, and the
// timelines (~0.2 GB at serving) are read from L2 by the MAC.
//
// What the design does about it. The TPU kernels walk the blocks as a
// sequential grid with the windows, h and the tables resident in VMEM; a
// Hopper CTA has 227 KB of shared memory and CTAs run in no order. But
// every input block of a scan is known up front, so the sequence dissolves
// into a frame timeline (scan_mac.cuh), and each step runs over all blocks
// of all channels at once:
//   1. fft_fwd_kernel (frame_fft.cuh, which the per-block steps of
//      blockstep.cu launch too): a CTA loads B = 2^log_b blocks' z straight from
//      `blocks` (float2 pairs, coalesced) into the first Stockham pass of
//      fft_tile (fft_tile.cuh, shared with fft.cu), transforms them in
//      shared memory and packs: one thread a bin pair (k, m-k), both bins
//      written into row row0 + t of channel c's timeline ([re | im]).
//   2. the timeline MAC of scan_mac.cuh (mac_tile_kernel: a CTA streams the
//      partitions of G * TT outputs x 32 bins through shared memory).
//   3. fft_inv_kernel: a CTA takes B output rows of one channel, writes
//      U(acc[t] + pm acc[t-1]) into shared memory (one thread a bin pair,
//      reading aext, whose rows 0 and nb+1 are zero), transforms it and
//      stores the first m/2 outputs, deinterleaved, from registers. Folding
//      the overlap-add into the transform's input costs one transform a
//      row and no pass of its own; keeping both output halves in scratch
//      and adding them in a second pass would move 2 (nb+1) m more floats
//      through device memory for the same transforms.
// A CTA holds 2^log_b rows, up to 2^13 values (512 threads at 64
// registers, two CTAs an SM, as fft.cu's leaf); the caller's plan
// (ops/cuda/streamstep.py fft_tile_log_b) picks the rows by shape, 2^11
// values or two rows a CTA where that grid fills the card (measured the
// fastest at pts 64..4096). m = 2^14 takes one row of 1024 threads. Above
// 2^14 the same pack and unpack run as kernels of their own around fft.cu's
// four-step (front then leaf, in fft_tile.cuh) on scratch planes. No
// atomics: every output is written by one thread, in a fixed order.
//
// The last entry, stream_steps_fused_matrix_f32, is the port's own: a
// convolution matrix's scan from the same steps at the channel count each
// needs, its MAC (mac_matrix_kernel) summing the (out, in) pairs over the
// inputs in the kernel. It replaces no TPU kernel.

#include <array>
#include <utility>

#include "frame_fft.cuh"   // fft_fwd_kernel and its launches; fft_tile.cuh, scan_mac.cuh

namespace {

constexpr int EW_THREADS = 256;                              // the four-step's pack kernels

// The spectrum U(acc[t] + pm acc[t-1]) at bins k (vr, vi) and m-k (ur, ui):
// cur = [acc_re[t] | acc_im[t]], prev the row before; the inverse
// coefficient rows [a1, b1, na2, nb2, c1, d1, nc2, nd2] (8, m).
__device__ __forceinline__ void unpack_pair(const float* __restrict__ cur,
                                            const float* __restrict__ prev,
                                            const float* __restrict__ ic, int m, int k, float& vr,
                                            float& vi, float& ur, float& ui) {
    const int mk = (m - k) & (m - 1);
    const float pm = (k & 1) ? -1.f : 1.f;   // (-1)^k == (-1)^(m-k)
    float a[2], bv[2], d[2], e[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int i = s ? mk : k;
        const float wr = cur[i] + pm * prev[i], wi = cur[m + i] + pm * prev[m + i];
        a[s] = wr * __ldg(ic + i) + wi * __ldg(ic + m + i);
        bv[s] = wr * __ldg(ic + 2 * m + i) + wi * __ldg(ic + 3 * m + i);
        d[s] = wr * __ldg(ic + 4 * m + i) + wi * __ldg(ic + 5 * m + i);
        e[s] = wr * __ldg(ic + 6 * m + i) + wi * __ldg(ic + 7 * m + i);
    }
    vr = a[0] + bv[1];
    vi = d[0] + e[1];
    ur = a[1] + bv[0];
    ui = d[1] + e[0];
}

// Output samples 2j, 2j+1 of row t of channel c from y_j = (re, im): the
// final tail at t = nb, else (y + tail at t = 0) / pts into outs row t*C + c.
__device__ __forceinline__ void ola_store(const Scan& s, int c, int t, int j, float re, float im,
                                          const float* __restrict__ tail0, float inv_pts,
                                          float* __restrict__ outs, float* __restrict__ tailf) {
    const size_t cm = static_cast<size_t>(c) * s.bins + 2 * j;
    if (t == s.nb) {
        *reinterpret_cast<float2*>(tailf + cm) = make_float2(re, im);
        return;
    }
    if (t == 0) {
        re += tail0[cm];
        im += tail0[cm + 1];
    }
    *reinterpret_cast<float2*>(outs + static_cast<size_t>(t) * s.C * s.bins + cm) =
        make_float2(re * inv_pts, im * inv_pts);
}

// Output rows t = 0..nb of channel c = blockIdx.y, B = 2^log_b a CTA, from
// aext (C, nb+2, 2m).
template <int LOG_L>
__global__ void __launch_bounds__(tile_threads<LOG_L>(), LOG_L == BIG_LOG2 ? 1 : MIN_BLOCKS)
fft_inv_kernel(Scan s, const float* __restrict__ aext, const float2* __restrict__ tw,
               const float* __restrict__ icoef, const float* __restrict__ tail0, float inv_pts,
               float* __restrict__ outs, float* __restrict__ tailf, int log_b) {
    constexpr int log_l = LOG_L;
    extern __shared__ float smem[];
    const Layout<false> lay{log_l, log_b, row_stride(log_l)};
    const int B = 1 << log_b, m = 1 << log_l, half = m >> 1;
    float* sr = smem;
    float* si = smem + B * lay.S;
    const int c = blockIdx.y, t0 = blockIdx.x << log_b;
    const float* ax = aext + c * s.ax();
    const int pairs = half + 1;
    for (int e = threadIdx.x; e < B * pairs; e += blockDim.x) {
        const int b = e / pairs, k = e - b * pairs, t = t0 + b;
        const int mk = (m - k) & (m - 1);
        float vr = 0.f, vi = 0.f, ur = 0.f, ui = 0.f;
        if (t <= s.nb) {
            const float* cur = ax + static_cast<size_t>(t + 1) * s.b2();
            unpack_pair(cur, cur - s.b2(), icoef, m, k, vr, vi, ur, ui);
        }
        sr[lay.smem(b, k)] = vr;
        si[lay.smem(b, k)] = vi;
        sr[lay.smem(b, mk)] = ur;
        si[lay.smem(b, mk)] = ui;
    }
    __syncthreads();
    auto sload = [&](int b, int q, float& re, float& im) {
        re = sr[lay.smem(b, q)];
        im = si[lay.smem(b, q)];
    };
    auto gstore = [&](int b, int j, float re, float im) {
        const int t = t0 + b;
        if (j < half && t <= s.nb) ola_store(s, c, t, j, re, im, tail0, inv_pts, outs, tailf);
    };
    fft_tile(lay, sr, si, sload, gstore, NoPre{}, false, tw, +1, true);
}

// The four-step's pack kernels, grid-stride over their elements. z planes
// (rows, m) of the rows of blocks, zero above m/2.
__global__ void __launch_bounds__(EW_THREADS)
z_planes_kernel(const float* __restrict__ blocks, long long rows, int log_l,
                float* __restrict__ zr, float* __restrict__ zi) {
    const int half = 1 << (log_l - 1);
    const size_t n = static_cast<size_t>(rows) << log_l;
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int q = static_cast<int>(i & ((1u << log_l) - 1));
        const size_t r = i >> log_l;
        const bool in = q < half;
        zr[i] = in ? blocks[(r << log_l) + 2 * q] : 0.f;
        zi[i] = in ? blocks[(r << log_l) + 2 * q + 1] : 0.f;
    }
}

// Z planes (rows, m) -> the packed frames in the timelines, a bin pair an
// element.
__global__ void __launch_bounds__(EW_THREADS)
pack_kernel(Scan s, int row0, const float* __restrict__ zr, const float* __restrict__ zi,
            const float* __restrict__ fcoef, float* __restrict__ tl, size_t tl_cs, int log_l) {
    const int m = 1 << log_l, pairs = m / 2 + 1;
    const size_t n = static_cast<size_t>(s.nb) * s.C * pairs;
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const long long br = static_cast<long long>(i / pairs);
        const int k = static_cast<int>(i - static_cast<size_t>(br) * pairs);
        const int mk = (m - k) & (m - 1);
        const int t = static_cast<int>(br / s.C), c = static_cast<int>(br - 1LL * t * s.C);
        float* row = tl + c * tl_cs + static_cast<size_t>(row0 + t) * s.b2();
        const size_t z0 = static_cast<size_t>(br) << log_l;
        const float a_r = zr[z0 + k], a_i = zi[z0 + k], f_r = zr[z0 + mk], f_i = zi[z0 + mk];
        pack_bin(fcoef, m, k, a_r, a_i, f_r, f_i, row);
        if (mk != k) pack_bin(fcoef, m, mk, f_r, f_i, a_r, a_i, row);
    }
}

// aext -> V planes (C (nb+1), m): row c (nb+1) + t holds U(acc[t] + pm
// acc[t-1]) of channel c, a bin pair an element.
__global__ void __launch_bounds__(EW_THREADS)
unpack_kernel(Scan s, const float* __restrict__ aext, const float* __restrict__ icoef,
              int log_l, float* __restrict__ vr, float* __restrict__ vi) {
    const int m = 1 << log_l, pairs = m / 2 + 1;
    const size_t rows = static_cast<size_t>(s.nb + 1) * s.C, n = rows * pairs;
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const size_t r = i / pairs;
        const int k = static_cast<int>(i - r * pairs), mk = (m - k) & (m - 1);
        const size_t c = r / (s.nb + 1), t = r - c * (s.nb + 1);
        const float* cur = aext + c * s.ax() + (t + 1) * s.b2();
        float a_r, a_i, f_r, f_i;
        unpack_pair(cur, cur - s.b2(), icoef, m, k, a_r, a_i, f_r, f_i);
        const size_t v0 = r << log_l;
        vr[v0 + k] = a_r;
        vi[v0 + k] = a_i;
        vr[v0 + mk] = f_r;
        vi[v0 + mk] = f_i;
    }
}

// Y planes (C (nb+1), m) -> outputs and final tails: y_j, j < m/2, of row
// c (nb+1) + t, an element each.
__global__ void __launch_bounds__(EW_THREADS)
ola_kernel(Scan s, const float* __restrict__ yr, const float* __restrict__ yi,
           const float* __restrict__ tail0, float inv_pts, float* __restrict__ outs,
           float* __restrict__ tailf, int log_l) {
    const int half = 1 << (log_l - 1);
    const size_t rows = static_cast<size_t>(s.nb + 1) * s.C, n = rows * half;
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const size_t r = i / half;
        const int j = static_cast<int>(i - r * half);
        const size_t c = r / (s.nb + 1), t = r - c * (s.nb + 1);
        const size_t y0 = r << log_l;
        ola_store(s, static_cast<int>(c), static_cast<int>(t), j, yr[y0 + j], yi[y0 + j], tail0,
                  inv_pts, outs, tailf);
    }
}

// A grid-stride kernel's CTAs: enough for the card, no more than the work.
unsigned ew_ctas(size_t n) {
    const size_t need = (n + EW_THREADS - 1) / EW_THREADS;
    return static_cast<unsigned>(need < 132 * 16 ? need : 132 * 16);
}

// The in-CTA inverse transform at m = 2^LOG_L, 2^g.log_b rows a CTA: the
// launch of fft_inv_kernel<LOG_L>.
template <int LOG_L>
cudaError_t launch_inv(const Scan& s, const float* aext, const float2* tw, const float* icoef,
                       const float* tail0, float inv_pts, float* outs, float* tailf,
                       const TileShape& g, dim3 grid, int device, cudaStream_t st) {
    RETURN_IF_ERROR(allow_smem(fft_inv_kernel<LOG_L>, device, g.smem, tile_granted[1][LOG_L]));
    fft_inv_kernel<LOG_L><<<grid, g.threads, g.smem, st>>>(s, aext, tw, icoef, tail0, inv_pts,
                                                           outs, tailf, g.log_b);
    return cudaGetLastError();
}

using InvLaunch = decltype(&launch_inv<1>);

template <int... L>
constexpr std::array<InvLaunch, sizeof...(L)> inv_launches(std::integer_sequence<int, L...>) {
    return {&launch_inv<L + 1>...};
}

// entry log2 m - 1: the launch at m = 2^1 .. 2^14
constexpr auto kInvLaunch = inv_launches(std::make_integer_sequence<int, BIG_LOG2>{});

// The m-point transforms of one sign: in the CTA (log_n1 == 0: tw2 the pass
// table of m) or the four-step at n1 x n2 (tw1, tw2 the pass tables of n1
// and n2; ta, tb, ts the leaf's twiddle tables, A's rows 2^log_a long).
struct Plan {
    const float* tw1;
    const float* tw2;
    const float* ta;
    const float* tb;
    const float* ts;
    int log_n1, log_a;
    int log_b;   // in the CTA: 2^log_b rows a CTA
};

// step 1 of the scans, as run_scan takes it. scratch: four planes of C
// (nb+1) m floats for the four-step, unused in the CTA.
struct FftFwd {
    Plan p;
    const float* fcoef;
    float* scratch;
    int device;
    cudaError_t operator()(const Scan& s, const float* blocks, float* tl, size_t tl_cs, int row0,
                           cudaStream_t st) const {
        const long long rows = static_cast<long long>(s.nb) * s.C;
        const int log_l = ilog2(s.bins);
        if (p.log_n1 == 0) {
            const TileShape g = tile_shape(log_l, p.log_b);
            const long long ctas = (rows + (1LL << g.log_b) - 1) >> g.log_b;
            if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
            return kFwdLaunch[log_l - 1](s, row0, blocks, reinterpret_cast<const float2*>(p.tw2),
                                         fcoef, tl, tl_cs, g, static_cast<unsigned>(ctas),
                                         device, st);
        }
        const size_t plane = static_cast<size_t>(rows) << log_l;
        float *zr = scratch, *zi = zr + plane, *fr = zi + plane, *fi = fr + plane;
        z_planes_kernel<<<ew_ctas(plane), EW_THREADS, 0, st>>>(blocks, rows, log_l, zr, zi);
        RETURN_IF_ERROR(cudaGetLastError());
        const int log_n2 = log_l - p.log_n1;
        RETURN_IF_ERROR(launch_front(zr, zi, fr, fi, p.tw1, rows, p.log_n1, log_n2, -1,
                                     device, st));
        RETURN_IF_ERROR(launch_rows(fr, fi, zr, zi, p.tw2, p.ta, p.tb, p.ts, p.log_a,
                                    rows << p.log_n1, log_n2, p.log_n1, -1, 1.f, device,
                                    st));
        pack_kernel<<<ew_ctas(static_cast<size_t>(rows) * (s.bins / 2 + 1)), EW_THREADS, 0, st>>>(
            s, row0, zr, zi, fcoef, tl, tl_cs, log_l);
        return cudaGetLastError();
    }
};

// step 3 of the scans, as run_scan takes it
struct FftPost {
    Plan p;
    const float* icoef;
    float* scratch;
    int device;
    cudaError_t operator()(const Scan& s, const float* aext, const float* tail0, float* outs,
                           float* tailf, cudaStream_t st) const {
        const int log_l = ilog2(s.bins);
        const float inv_pts = 1.0f / static_cast<float>(s.bins);
        if (p.log_n1 == 0) {
            const TileShape g = tile_shape(log_l, p.log_b);
            const dim3 grid((s.nb + (1 << g.log_b)) >> g.log_b, s.C);
            return kInvLaunch[log_l - 1](s, aext, reinterpret_cast<const float2*>(p.tw2), icoef,
                                         tail0, inv_pts, outs, tailf, g, grid, device, st);
        }
        const long long rows = (s.nb + 1LL) * s.C;
        const size_t plane = static_cast<size_t>(rows) << log_l;
        float *vr = scratch, *vi = vr + plane, *fr = vi + plane, *fi = fr + plane;
        unpack_kernel<<<ew_ctas(static_cast<size_t>(rows) * (s.bins / 2 + 1)), EW_THREADS, 0,
                        st>>>(s, aext, icoef, log_l, vr, vi);
        RETURN_IF_ERROR(cudaGetLastError());
        const int log_n2 = log_l - p.log_n1;
        RETURN_IF_ERROR(launch_front(vr, vi, fr, fi, p.tw1, rows, p.log_n1, log_n2, +1,
                                     device, st));
        RETURN_IF_ERROR(launch_rows(fr, fi, vr, vi, p.tw2, p.ta, p.tb, p.ts, p.log_a,
                                    rows << p.log_n1, log_n2, p.log_n1, +1, 1.f, device,
                                    st));
        ola_kernel<<<ew_ctas(static_cast<size_t>(rows) * (s.bins / 2)), EW_THREADS, 0, st>>>(
            s, vr, vi, tail0, inv_pts, outs, tailf, log_l);
        return cudaGetLastError();
    }
};

// The C entries' shared checks and plans. tabs: 10 device pointers, the
// forward plan's (sign -1) [tw1, tw2, ta, tb, ts] then the inverse's (+1).
// plan: 6 host ints, the in-CTA transforms' log2 rows a CTA (forward,
// inverse) and the MAC's groups, outputs a thread, stage partitions and
// ring rows.
cudaError_t plans(const float* const* tabs, int pts, int log_n1, int log_a, const int* plan,
                  const float* scratch, Plan& fwd, Plan& inv, MacPlan& mac) {
    if (pts < 2 || (pts & (pts - 1)) != 0 || plan == nullptr) return cudaErrorInvalidValue;
    const int log_l = ilog2(pts);
    if (log_n1 == 0 ? (log_l > BIG_LOG2 || !tile_ok(log_l, plan[0]) || !tile_ok(log_l, plan[1]))
                    : (log_l <= BIG_LOG2 || log_n1 > TILE_LOG2 || log_l - log_n1 > TILE_LOG2
                       || log_n1 < 1 || log_l - log_n1 < 1 || scratch == nullptr))
        return cudaErrorInvalidValue;
    fwd = {tabs[0], tabs[1], tabs[2], tabs[3], tabs[4], log_n1, log_a, plan[0]};
    inv = {tabs[5], tabs[6], tabs[7], tabs[8], tabs[9], log_n1, log_a, plan[1]};
    mac = {plan[2], plan[3], plan[4], plan[5]};
    return mac.ok() ? cudaSuccess : cudaErrorInvalidValue;
}

// The matrix MAC of stream_steps_fused_matrix_f32: output o of n_out sums,
// for each input i in ascending order, the tiled LTI MAC of input i's
// timeline against pair (o, i)'s IR planes over the partitions, and gives
// aext's zero rows 0 and nb + 1 of output o. The stages of all inputs run
// through scan_mac.cuh's mac_stage / mac_chunk as one cp.async pipeline:
// input i + 1's first stage is copied after input i's last one is
// multiplied. Copying it during that last stage takes a second ring and so
// twice the LTI MAC's shared memory, one CTA an SM instead of two; it was
// measured slower on the H100 (the MAC 3,637 against 3,518 us at 16 x 16,
// 74.4 against 70.3 at 2 x 2, pts 512 and 470 blocks): two CTAs an SM hide
// each other's first-stage copies. A CTA's MacTile serves the copies only
// (mac_chunk reads its ring mask), so it is pointed at input i + 1 before
// that input's first copy.
//
// The sums. A thread sums MATRIX_GROUP inputs' products from zero in its
// registers, then adds that group's sum (bin 0 times b0) into its output
// rows of aext: the first group stores, the others add by atomicAdd with
// no return (one RED a value; each value has one writer, whose adds land in
// program order, so the result is the same every launch). One sum over all
// 16 x 256 products of an output loses several times more to rounding
// (1.7e-6 of the float64 reference against 2.8e-7 for the pair route, H100,
// 16 x 16, 256 partitions); from HBM the entry took 3,429-3,435 us a call
// so, against 3,528-3,559 for groups of 2 (3.2e-7 on the CPU twin), 3,663-
// 3,678 for groups of 1 and 3,608 for groups of 4 added by plain loads and
// stores. The adds' addresses are made from pointers hidden from the
// compiler in each flush: hoisted out of the input loop they held 4 TT
// registers through the MAC (202 a thread, one CTA an SM).
constexpr int MATRIX_GROUP = 2;

template <int TT, bool DC_TILE>
__device__ __forceinline__ void mac_matrix_tile(const Scan& s, const MacPlan& p,
                                                const MacIO& io, MacTile& m, int o, int n_in,
                                                float b0, float2* smem) {
    float2* sx = smem;
    float2* sh = sx + (m.rmask + 1) * TILE_BINS;
    const int gt = threadIdx.y * TT;
    const bool dc = DC_TILE && m.k == 0;
    float ar[TT], ai[TT];   // the sums of a group of inputs
#pragma unroll
    for (int j = 0; j < TT; ++j) ar[j] = ai[j] = 0.f;
    const int chunks = cdiv(s.nparts, p.q);
    const float* xr0 = m.xb;
    const float* xi0 = m.xbi;
    auto point = [&](int i) {                          // the copies of input i
        m.xb = xr0 + i * io.xcs;
        m.xbi = xi0 + i * io.xcs;
        const size_t pair = static_cast<size_t>(o) * n_in + i;
        m.hrc = io.hr + pair * io.hcs;
        m.hic = io.hi + pair * io.hcs;
    };
    point(0);
    mac_stage<H_LTI>(s, p, m, 0, sx, sh);
    cp_async_commit();
    for (int i = 0; i < n_in; ++i) {
        for (int ch = 0; ch < chunks; ++ch) {
            if (ch + 1 < chunks) {
                mac_stage<H_LTI>(s, p, m, ch + 1, sx, sh);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            mac_chunk<H_LTI, TT, DC_TILE>(s, p, m, ch, gt, dc, sx, sh, ar, ai);
            __syncthreads();   // before a later stage overwrites what this one read
        }
        if (i + 1 < n_in) {
            point(i + 1);
            mac_stage<H_LTI>(s, p, m, 0, sx, sh);
            cp_async_commit();
        }
        if (i + 1 < n_in && (i + 1) % MATRIX_GROUP) continue;
        float* yr = m.outr + static_cast<size_t>(gt) * m.os + m.k;
        float* yi = m.outi + static_cast<size_t>(gt) * m.os + m.k;
        asm volatile("" : "+l"(yr), "+l"(yi));
        const bool first = i < MATRIX_GROUP;
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            if (m.kin && m.t0 + gt + j < s.nb) {
                const float vr = dc ? b0 * ar[j] : ar[j], vi = dc ? b0 * ai[j] : ai[j];
                if (first) {
                    *yr = vr;
                    *yi = vi;
                } else {
                    atomicAdd(yr, vr);
                    atomicAdd(yi, vi);
                }
            }
            yr += m.os;
            yi += m.os;
            ar[j] = ai[j] = 0.f;
        }
    }
    if (!m.kin || threadIdx.y != 0) return;
    if (m.t0 == 0) (m.outr - m.os)[m.k] = (m.outi - m.os)[m.k] = 0.f;
    if (m.t0 + m.T >= s.nb) {
        const size_t last = static_cast<size_t>(s.nb - m.t0) * m.os + m.k;
        m.outr[last] = m.outi[last] = 0.f;
    }
}

// grid (cdiv(nb, p.outs()), cdiv(bins, 32), n_out), block (32, p.groups),
// the LTI MAC's p.smem_floats(H_LTI) floats of dynamic shared memory: io's
// x planes are the n_in timelines, its h planes the n_out n_in pairs (pair
// o n_in + i), its outputs the n_out channels of aext. Bounded to two CTAs
// an SM (128 registers), as the LTI MAC reaches by itself. The TILE_TT_MAX
// form takes 128 registers without the bound too: on the H100 the entry
// ran 3,563-3,566 us at 16 x 16 (pts 512, 470 blocks) with it and
// 3,583-3,589 without; the bound holds two CTAs an SM against later edits.
template <int TT>
__global__ void __launch_bounds__(TILE_BINS * TILE_MAX_GROUPS, 2)
mac_matrix_kernel(Scan s, MacPlan p, MacIO io, int n_in, float b0) {
    extern __shared__ float2 smem2[];
    const int o = blockIdx.z;
    MacTile m;
    m.T = p.outs();
    m.t0 = blockIdx.x * m.T;
    m.k = blockIdx.y * TILE_BINS + threadIdx.x;
    m.kin = m.k < s.bins;
    m.xrows = io.xrows - m.t0;
    m.xb = io.xr + static_cast<size_t>(m.t0) * io.xs;
    m.xbi = io.xi + static_cast<size_t>(m.t0) * io.xs;
    m.xs = io.xs;
    m.wp2_0 = 0;
    m.rmask = p.ring - 1;
    m.hs = io.hs;
    const size_t oo = static_cast<size_t>(o) * io.ocs + static_cast<size_t>(m.t0) * io.os;
    m.outr = io.outr + oo;
    m.outi = io.outi + oo;
    m.os = io.os;
    if (blockIdx.y == 0)
        mac_matrix_tile<TT, true>(s, p, io, m, o, n_in, b0, smem2);
    else
        mac_matrix_tile<TT, false>(s, p, io, m, o, n_in, b0, smem2);
}

size_t matrix_granted[2][64];   // [tt == TILE_TT_MAX][device]

template <int TT>
cudaError_t launch_matrix_tile(const Scan& so, const MacPlan& p, const MacIO& io, int n_in,
                               float b0, int device, cudaStream_t st) {
    const dim3 grid(cdiv(so.nb, p.outs()), cdiv(so.bins, TILE_BINS), so.C);
    const size_t smem = sizeof(float) * p.smem_floats(H_LTI);
    RETURN_IF_ERROR(allow_smem(mac_matrix_kernel<TT>, device, smem,
                               matrix_granted[TT == TILE_TT_MAX]));
    mac_matrix_kernel<TT><<<grid, dim3(TILE_BINS, p.groups), smem, st>>>(so, p, io, n_in, b0);
    return cudaGetLastError();
}

// run_scan's steps at the channel count each needs: the window and the
// forward transform at the n_in inputs (si), the matrix MAC and the inverse
// transform at the n_out outputs (so), the final windows at the inputs.
// aext holds max(n_in, n_out) channels: window_in_kernel zeroes the rows of
// the first n_in, the matrix MAC those of the n_out it writes.
cudaError_t run_matrix_scan(const Scan& si, const Scan& so, const float* blocks,
                            const float* w0r, const float* w0i, const float* hr,
                            const float* hi, const FftFwd& fwd, const FftPost& post,
                            const MacPlan& mac, const float* tail0, float* outs, float* wfr,
                            float* wfi, float* tailf, float* timeline, float* aext,
                            float b0_scale, int device, cudaStream_t st) {
    const dim3 rows(si.nparts, si.C);
    window_in_kernel<<<rows, ROW_THREADS, 0, st>>>(si, w0r, w0i, timeline, aext);
    RETURN_IF_ERROR(cudaGetLastError());
    RETURN_IF_ERROR(fwd(si, blocks, timeline, si.tl(), si.nparts, st));
    const MacIO io = scan_io(so, false, timeline, hr, hi, aext);
    RETURN_IF_ERROR(mac.tt == MAC_TT
                        ? launch_matrix_tile<MAC_TT>(so, mac, io, si.C, b0_scale, device, st)
                        : launch_matrix_tile<TILE_TT_MAX>(so, mac, io, si.C, b0_scale, device,
                                                          st));
    RETURN_IF_ERROR(post(so, aext, tail0, outs, tailf, st));
    window_out_kernel<<<rows, ROW_THREADS, 0, st>>>(si, timeline, wfr, wfi);
    return cudaGetLastError();
}

}  // namespace

// One LTI scan of nb blocks of C channels. All pointers but tabs and plan
// are float32 device memory on `device`; blocks (8-byte aligned) and outs
// are (nb, C, pts), the windows and IR planes (C, nparts, pts), the tails
// (C, pts), fcoef and icoef (8, pts) (ops/cuda/tables.py _coef_stacks_np).
// tabs: a host array of 10 device pointers to the transforms' float32
// tables ((re, im) interleaved, sign baked in; ops/cuda/vmemfft.py): for
// sign -1 then +1, the pass tables of n1 and n2 = pts / n1 and the
// four-step tables A, B, S at log_a (four_step_tables_np). pts <= 2^14:
// log_n1 = 0, one transform in a CTA, only the pass tables of pts (the
// second of each five) are read. pts > 2^14: n1 = 2^log_n1, both factors in
// [2, 2^13]. plan: a host array of 6 ints (see plans). The caller
// allocates outputs and scratch:
//   timeline (C, nparts+nb, 2*pts), aext (C, nb+2, 2*pts), and for pts >
//   2^14 scratch of 4 C (nb+1) pts floats (else null).
// Launches on `stream` without synchronising; returns the first CUDA error.
extern "C" int stream_steps_fused_batched_f32(
    const float* blocks, const float* w0r, const float* w0i, const float* hr, const float* hi,
    const float* const* tabs, const float* fcoef, const float* icoef, const float* tail0,
    float* outs, float* wfr, float* wfi, float* tailf, float* timeline, float* aext,
    float* scratch, int nb, int C, int nparts, int pts, int log_n1, int log_a, const int* plan,
    float b0_scale, int device, void* stream_ptr) {
    RETURN_IF_ERROR(cudaSetDevice(device));
    Plan fwd, inv;
    MacPlan mac;
    RETURN_IF_ERROR(plans(tabs, pts, log_n1, log_a, plan, scratch, fwd, inv, mac));
    const Scan s{nb, C, nparts, pts};
    return run_scan<false>(s, blocks, w0r, w0i, hr, hi, nullptr, 0,
                           FftFwd{fwd, fcoef, scratch, device},
                           FftPost{inv, icoef, scratch, device}, mac, tail0, outs, wfr, wfi,
                           tailf, timeline, aext, b0_scale, device,
                           static_cast<cudaStream_t>(stream_ptr));
}

// One TV scan of nb blocks of C channels: blocks_x / blocks_h (nb, C, pts),
// initial coefficient rings (h0r, h0i) (C, nparts, pts), channel c's ring
// pointer wp2[c * wp2_stride] in [0, nparts) (int32 device memory; stride 0
// shares one pointer); (hfr, hfi) receive the final rings. Tables, plan and
// scratch as the LTI scan's, plus htimeline (C, nparts-1+nb, 2*pts).
extern "C" int stream_steps_fused_batched_tv_f32(
    const float* blocks_x, const float* blocks_h, const float* w0r, const float* w0i,
    const float* h0r, const float* h0i, const int* wp2, int wp2_stride,
    const float* const* tabs, const float* fcoef, const float* icoef, const float* tail0,
    float* outs, float* wfr, float* wfi, float* hfr, float* hfi, float* tailf,
    float* timeline, float* htimeline, float* aext, float* scratch, int nb, int C, int nparts,
    int pts, int log_n1, int log_a, const int* plan, float b0_scale, int device,
    void* stream_ptr) {
    RETURN_IF_ERROR(cudaSetDevice(device));
    Plan fwd, inv;
    MacPlan mac;
    RETURN_IF_ERROR(plans(tabs, pts, log_n1, log_a, plan, scratch, fwd, inv, mac));
    const Scan s{nb, C, nparts, pts};
    return run_tv_scan(s, blocks_x, blocks_h, w0r, w0i, h0r, h0i, wp2, wp2_stride,
                       FftFwd{fwd, fcoef, scratch, device}, FftPost{inv, icoef, scratch, device},
                       mac, tail0, outs, wfr, wfi, hfr, hfi, tailf, timeline, htimeline, aext,
                       b0_scale, device, static_cast<cudaStream_t>(stream_ptr));
}

// One scan of a convolution matrix: nb blocks of n_in inputs through n_out
// x n_in IRs into n_out outputs, out[o] = sum_i in[i] * ir[o, i]. A new
// design, not a port (the JAX package runs the matrix as n_out n_in
// channels of the batched scan): one forward transform and one window an
// input, the MAC of every pair summed over the inputs inside the kernel
// (mac_matrix_kernel), one inverse transform and tail an output. At 16 x 16,
// pts 512, nparts 256 and 470 blocks the MAC's 126.2 GFLOP (126.5 with the
// 32 transforms a block) bound it: 1.89 ms at 67 TFLOP/s, where the bytes
// (the 268 MB of IR spectra read once) take 0.1 ms. blocks (nb, n_in, pts)
// and outs (nb, n_out, pts); w0 and the final windows (n_in, nparts, pts);
// hr, hi (n_out n_in, nparts, pts), pair (o, i) at o n_in + i; tail0 and
// tailf (n_out, pts). Tables and scratch as the LTI scan's, the scratch 4
// max(n_in, n_out) (nb+1) pts floats above 2^14; timeline (n_in, nparts+nb,
// 2*pts), aext (max(n_in, n_out), nb+2, 2*pts). plan: 6 host ints, as the
// LTI scan's (the forward transform's rows a CTA planned over nb n_in rows,
// the inverse's over n_out sequences of nb+1, the MAC's at n_out channels).
extern "C" int stream_steps_fused_matrix_f32(
    const float* blocks, const float* w0r, const float* w0i, const float* hr, const float* hi,
    const float* const* tabs, const float* fcoef, const float* icoef, const float* tail0,
    float* outs, float* wfr, float* wfi, float* tailf, float* timeline, float* aext,
    float* scratch, int nb, int n_in, int n_out, int nparts, int pts, int log_n1, int log_a,
    const int* plan, float b0_scale, int device, void* stream_ptr) {
    RETURN_IF_ERROR(cudaSetDevice(device));
    Plan fwd, inv;
    MacPlan mac;
    RETURN_IF_ERROR(plans(tabs, pts, log_n1, log_a, plan, scratch, fwd, inv, mac));
    if (n_in < 1 || n_out < 1) return cudaErrorInvalidValue;
    const Scan si{nb, n_in, nparts, pts}, so{nb, n_out, nparts, pts};
    return run_matrix_scan(si, so, blocks, w0r, w0i, hr, hi, FftFwd{fwd, fcoef, scratch, device},
                           FftPost{inv, icoef, scratch, device}, mac, tail0, outs, wfr, wfi,
                           tailf, timeline, aext, b0_scale, device,
                           static_cast<cudaStream_t>(stream_ptr));
}
