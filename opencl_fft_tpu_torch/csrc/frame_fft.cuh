// The frames' forward transform inside a CTA, shared by the whole scans
// (streamstep.cu, step 1 of run_scan) and the per-block steps
// (blockstep.cu): fft_fwd_kernel<log2 m> turns rows of blocks into packed
// frame spectra (the zero-padded 2m-sample frame of block x is the
// half-size sequence z_j = x_2j + i x_2j+1; Z = FFT_m(z); packed bin k from
// Z_k and Z_(m-k) through the forward coefficient rows of
// ops/cuda/tables.py _coef_stacks_np) and writes them into a channel's
// [re | im] rows; the tile shapes and launches by length (kFwdLaunch).
// Rows of a CTA past the last block read as zero and are not written, so a
// caller may give a CTA more rows than it has blocks (more threads a row).

#pragma once

#include <array>
#include <utility>

#include "fft_tile.cuh"
#include "scan_mac.cuh"

namespace {

constexpr int BIG_LOG2 = 14;                                 // the largest in-CTA transform
constexpr int BIG_THREADS = (1 << BIG_LOG2) / PER_THREAD;   // one row of 2^14 a CTA

// Packed bin k of a frame from (zr, zi) = Z_k and (fr, fi) = Z_(m-k):
// the forward coefficient rows [a1, a2, b1, b2, c1, c2, d1, d2] (8, m).
__device__ __forceinline__ void pack_bin(const float* __restrict__ fc, int m, int k, float zr,
                                         float zi, float fr, float fi, float* __restrict__ row) {
    fc += k;
    row[k] = zr * __ldg(fc) + fr * __ldg(fc + m) + zi * __ldg(fc + 2 * m) + fi * __ldg(fc + 3 * m);
    row[m + k] = zr * __ldg(fc + 4 * m) + fr * __ldg(fc + 5 * m) + zi * __ldg(fc + 6 * m)
        + fi * __ldg(fc + 7 * m);
}

// The transform kernels are built once per length m = 2^LOG_L, so that
// their passes unroll and their strides fold (as fft.cu's single pass):
// 512 threads at most, two CTAs an SM, or one row of 2^14 on 1024.
template <int LOG_L>
constexpr int tile_threads() {
    return LOG_L == BIG_LOG2 ? BIG_THREADS : MAX_THREADS;
}

// Frames of the rows of blocks ((nb*C, m): row t*C + c), B = 2^log_b a CTA,
// into row row0 + t of channel c's timeline (channel stride tl_cs).
template <int LOG_L>
__global__ void __launch_bounds__(tile_threads<LOG_L>(), LOG_L == BIG_LOG2 ? 1 : MIN_BLOCKS)
fft_fwd_kernel(Scan s, int row0, const float* __restrict__ blocks, const float2* __restrict__ tw,
               const float* __restrict__ fcoef, float* __restrict__ tl, size_t tl_cs,
               int log_b) {
    constexpr int log_l = LOG_L;
    extern __shared__ float smem[];
    const Layout<false> lay{log_l, log_b, row_stride(log_l)};
    const int B = 1 << log_b, m = 1 << log_l, half = m >> 1;
    float* sr = smem;
    float* si = smem + B * lay.S;
    const long long nrows = static_cast<long long>(s.nb) * s.C;
    const long long r0 = static_cast<long long>(blockIdx.x) << log_b;
    const float2* z = reinterpret_cast<const float2*>(blocks);
    auto gload = [&](int b, int q, float& re, float& im) {
        const bool in = q < half && r0 + b < nrows;
        const float2 v = in ? __ldg(z + static_cast<size_t>(r0 + b) * half + q)
                            : make_float2(0.f, 0.f);
        re = v.x;
        im = v.y;
    };
    auto sstore = [&](int b, int k, float re, float im) {
        sr[lay.smem(b, k)] = re;
        si[lay.smem(b, k)] = im;
    };
    fft_tile(lay, sr, si, gload, sstore, NoPre{}, true, tw, -1);
    __syncthreads();
    const int pairs = half + 1;   // (k, m-k) for k = 0..m/2
    for (int e = threadIdx.x; e < B * pairs; e += blockDim.x) {
        const int b = e / pairs, k = e - b * pairs;
        const long long br = r0 + b;
        if (br >= nrows) break;   // later e have no smaller b
        const int mk = (m - k) & (m - 1);
        const int t = static_cast<int>(br / s.C), c = static_cast<int>(br - 1LL * t * s.C);
        float* row = tl + c * tl_cs + static_cast<size_t>(row0 + t) * s.b2();
        const float zr = sr[lay.smem(b, k)], zi = si[lay.smem(b, k)];
        const float fr = sr[lay.smem(b, mk)], fi = si[lay.smem(b, mk)];
        pack_bin(fcoef, m, k, zr, zi, fr, fi, row);
        if (mk != k) pack_bin(fcoef, m, mk, fr, fi, zr, zi, row);
    }
}

// The in-CTA tile of 2^log_b transforms of m = 2^log_l: its threads and
// shared memory. log_b comes from the caller's plan: at most 2^13 values a
// CTA (one row of 2^14 at m = 2^14), at least 16 (one thread).
struct TileShape {
    int log_b;
    int threads;
    size_t smem;
};

bool tile_ok(int log_l, int log_b) {
    return log_b >= 0 && log_l + log_b >= 4
        && (log_l == BIG_LOG2 ? log_b == 0 : log_l + log_b <= TILE_LOG2);
}

TileShape tile_shape(int log_l, int log_b) {
    const int threads = (1 << (log_l + log_b)) / PER_THREAD;
    return {log_b, threads, 2 * sizeof(float) * (static_cast<size_t>(row_stride(log_l)) << log_b)};
}

size_t tile_granted[2][BIG_LOG2 + 1][64];   // [inverse][log2 m][device]

// The in-CTA forward transform at m = 2^LOG_L, 2^g.log_b rows a CTA: the
// launch of fft_fwd_kernel<LOG_L>.
template <int LOG_L>
cudaError_t launch_fwd(const Scan& s, int row0, const float* blocks, const float2* tw,
                       const float* fcoef, float* tl, size_t tl_cs, const TileShape& g,
                       unsigned ctas, int device, cudaStream_t st) {
    RETURN_IF_ERROR(allow_smem(fft_fwd_kernel<LOG_L>, device, g.smem, tile_granted[0][LOG_L]));
    fft_fwd_kernel<LOG_L><<<ctas, g.threads, g.smem, st>>>(s, row0, blocks, tw, fcoef, tl, tl_cs,
                                                           g.log_b);
    return cudaGetLastError();
}

using FwdLaunch = decltype(&launch_fwd<1>);

template <int... L>
constexpr std::array<FwdLaunch, sizeof...(L)> fwd_launches(std::integer_sequence<int, L...>) {
    return {&launch_fwd<L + 1>...};
}

// entry log2 m - 1: the launch at m = 2^1 .. 2^14
constexpr auto kFwdLaunch = fwd_launches(std::make_integer_sequence<int, BIG_LOG2>{});

}  // namespace
