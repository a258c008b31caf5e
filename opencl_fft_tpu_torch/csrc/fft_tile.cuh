// The batched complex FFT's tile machinery, shared by fft.cu (the FFT
// entries) and streamstep.cu (the scans' in-kernel transforms).
//
// A CTA holds a tile of B = 2^log_b transforms of length L = 2^log_l in
// shared memory (float32 split planes) and runs Stockham passes of radix 16
// (the last one of radix 2, 4 or 8 when L is not a power of 16) over it:
// each thread holds 16 values in registers and does its butterfly there,
// exchanging through shared memory between passes (fft_tile). The first
// pass reads with a caller's gload, the last writes with a caller's lstore,
// so a kernel fuses its own loads and stores around the transform. Twiddles
// come from a float32 pass table built in float64 on the host (ops/cuda/
// vmemfft.py pass_twiddle_np: W_L^(r k) laid out pass by pass so that a
// warp reads adjacent entries; the sign is baked in). The constants inside
// a radix-8/16 butterfly are W_16^m. Shared memory pads one float per 32
// (p -> p + p/32) against bank conflicts of the strided Stockham writes;
// rows of a row tile sit at an odd stride (row_stride).
//
// Above one tile, the four-step at n = n1 x n2: fft_front_kernel
// transforms the columns of each (n1, n2) matrix, then the leaf
// fft_rows_kernel multiplies by W_n^(k1 j2) as it loads (tables A, B and S
// of vmemfft.py four_step_tables_np), transforms the rows and stores them
// transposed, in natural order. launch_front / launch_rows size and launch
// them. All offsets into the planes are 64-bit.

#pragma once

#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int PER_THREAD = 16;              // values a thread holds in a pass
constexpr int TILE_LOG2 = 13;               // complex values per CTA, log2
constexpr int MAX_THREADS = (1 << TILE_LOG2) / PER_THREAD;
// Two CTAs per SM, so that one loads or stores while the other computes:
// this caps the kernels at 64 registers, which they fit without spilling.
// Chosen by timing on the H100 against one CTA per SM (128 registers) and
// against 4096- and 2048-value tiles at two to four CTAs per SM: faster than
// one CTA at every sweep size, and than the smaller tiles above 2^12; and
// against 2^14-value tiles at one CTA per SM for both passes of 2^14..2^20.
constexpr int MIN_BLOCKS = 2;

__host__ __device__ __forceinline__ int pidx(int p) { return p + (p >> 5); }

__host__ __device__ constexpr int row_stride(int log_l) {
    const int l = 1 << log_l;
    return l + (l >> 5) + 1;
}

// W_16^m = cos + i sign sin of 2 pi m / 16, m < 16.
__device__ constexpr float kCos16[16] = {
    1.f, 0.92387953251128674f, 0.70710678118654757f, 0.38268343236508978f,
    0.f, -0.38268343236508978f, -0.70710678118654757f, -0.92387953251128674f,
    -1.f, -0.92387953251128674f, -0.70710678118654757f, -0.38268343236508978f,
    0.f, 0.38268343236508978f, 0.70710678118654757f, 0.92387953251128674f};
__device__ constexpr float kSin16[16] = {
    0.f, 0.38268343236508978f, 0.70710678118654757f, 0.92387953251128674f,
    1.f, 0.92387953251128674f, 0.70710678118654757f, 0.38268343236508978f,
    0.f, -0.38268343236508978f, -0.70710678118654757f, -0.92387953251128674f,
    -1.f, -0.92387953251128674f, -0.70710678118654757f, -0.38268343236508978f};

template <int R> struct Log2;
template <> struct Log2<2> { static constexpr int value = 1; };
template <> struct Log2<4> { static constexpr int value = 2; };
template <> struct Log2<8> { static constexpr int value = 3; };
template <> struct Log2<16> { static constexpr int value = 4; };

template <int R> struct Dft;

template <>
struct Dft<2> {
    static __device__ __forceinline__ void run(float (&xr)[2], float (&xi)[2], int) {
        const float ar = xr[0], ai = xi[0];
        xr[0] = ar + xr[1];
        xi[0] = ai + xi[1];
        xr[1] = ar - xr[1];
        xi[1] = ai - xi[1];
    }
};

template <>
struct Dft<4> {
    // X1 = (x0 - x2) + w (x1 - x3), X3 = (x0 - x2) - w (x1 - x3), w = sign i
    static __device__ __forceinline__ void run(float (&xr)[4], float (&xi)[4], int sign) {
        const float s02r = xr[0] + xr[2], s02i = xi[0] + xi[2];
        const float d02r = xr[0] - xr[2], d02i = xi[0] - xi[2];
        const float s13r = xr[1] + xr[3], s13i = xi[1] + xi[3];
        const float d13r = xr[1] - xr[3], d13i = xi[1] - xi[3];
        const float wdr = -sign * d13i, wdi = sign * d13r;
        xr[0] = s02r + s13r;
        xi[0] = s02i + s13i;
        xr[1] = d02r + wdr;
        xi[1] = d02i + wdi;
        xr[2] = s02r - s13r;
        xi[2] = s02i - s13i;
        xr[3] = d02r - wdr;
        xi[3] = d02i - wdi;
    }
};

// In-register DFT_R, natural order in and out: X[k] = sum_r x[r] W_R^(rk),
// W_R = exp(sign 2 pi i / R). R = 8, 16 as the four-step 4 x (R/4):
// X[k1 + 4 k2] = sum_n2 W_(R/4)^(n2 k2) W_R^(n2 k1) sum_n1 x[n1 R/4 + n2] W_4^(n1 k1).
template <int R>
struct Dft {
    static __device__ __forceinline__ void run(float (&xr)[R], float (&xi)[R], int sign) {
        constexpr int R2 = R / 4;
        float ar[4][R2], ai[4][R2];
#pragma unroll
        for (int n2 = 0; n2 < R2; ++n2) {
            float tr[4], ti[4];
#pragma unroll
            for (int n1 = 0; n1 < 4; ++n1) {
                tr[n1] = xr[n1 * R2 + n2];
                ti[n1] = xi[n1 * R2 + n2];
            }
            Dft<4>::run(tr, ti, sign);
#pragma unroll
            for (int k1 = 0; k1 < 4; ++k1) {
                const int m = (n2 * k1 * (16 / R)) & 15;   // W_R^(n2 k1) = W_16^m
                if (m == 0) {
                    ar[k1][n2] = tr[k1];
                    ai[k1][n2] = ti[k1];
                } else {
                    const float wr = kCos16[m], wi = sign * kSin16[m];
                    ar[k1][n2] = tr[k1] * wr - ti[k1] * wi;
                    ai[k1][n2] = tr[k1] * wi + ti[k1] * wr;
                }
            }
        }
#pragma unroll
        for (int k1 = 0; k1 < 4; ++k1) {
            Dft<R2>::run(ar[k1], ai[k1], sign);
#pragma unroll
            for (int k2 = 0; k2 < R2; ++k2) {
                xr[k1 + 4 * k2] = ar[k1][k2];
                xi[k1 + 4 * k2] = ai[k1][k2];
            }
        }
    }
};

// The tile's transforms: B = 2^log_b of length L = 2^log_l. Butterfly bf of
// a pass (j its index inside its transform, b the transform) and element
// (b, p) in shared memory are placed by the tile's layout: a row tile runs
// j fastest over the threads and keeps transform b at b * S; a column tile
// (COLS) runs b fastest and interleaves the transforms, element (b, p) at
// p * B + b, so threads next to each other touch neighbouring columns.
template <bool COLS>
struct Layout {
    int log_l, log_b, S;
    __device__ __forceinline__ void butterfly(int bf, int log_lr, int& b, int& j) const {
        if (COLS) {
            b = bf & ((1 << log_b) - 1);
            j = bf >> log_b;
        } else {
            b = bf >> log_lr;
            j = bf & ((1 << log_lr) - 1);
        }
    }
    __device__ __forceinline__ int smem(int b, int p) const {
        return COLS ? pidx((p << log_b) + b) : b * S + pidx(p);
    }
};

// One Stockham pass of radix R at sub-transform size ns over the tile:
//   v[r] = x[j + r L/R] * W_L^(r k), k = (j mod ns) * L / (ns R)
//   y[(j / ns) ns R + j mod ns + r ns] = DFT_R(v)[r].
// The twiddles are this pass's block of the pass table: W_L^(r k) at
// tw[toff + (r - 1) ns + j mod ns], so the threads of a warp (adjacent j)
// read adjacent entries for each r.
// load(b, p, re, im) reads element p of transform b of the pass's input,
// pre(b, j, x_re, x_im) may scale the R values of butterfly j as loaded,
// store(b, p, re, im) writes the output; `exchange` puts a barrier between
// the reads and the writes (input and output share the shared memory), and
// mid() runs after it, before the writes.
template <int R, bool COLS, typename Load, typename Store, typename Pre, typename Mid>
__device__ __forceinline__ void stockham_pass(const Layout<COLS>& lay, Load load, Store store,
                                              Pre pre, const float2* __restrict__ tw, int toff,
                                              int ns, int sign, bool exchange, Mid mid) {
    constexpr int NB = PER_THREAD / R;
    const int log_lr = lay.log_l - Log2<R>::value;
    const int lr = 1 << log_lr;
    float vr[NB][R], vi[NB][R];
    int bs[NB], js[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        lay.butterfly(threadIdx.x + i * blockDim.x, log_lr, bs[i], js[i]);
#pragma unroll
        for (int r = 0; r < R; ++r) load(bs[i], js[i] + r * lr, vr[i][r], vi[i][r]);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        pre(bs[i], js[i], vr[i], vi[i]);
        if (ns > 1) {
            const float2* w = tw + toff + (js[i] & (ns - 1));
#pragma unroll
            for (int r = 1; r < R; ++r) {
                const float2 t = __ldg(w + (r - 1) * ns);
                const float xr = vr[i][r], xi = vi[i][r];
                vr[i][r] = xr * t.x - xi * t.y;
                vi[i][r] = xr * t.y + xi * t.x;
            }
        }
        Dft<R>::run(vr[i], vi[i], sign);
    }
    if (exchange) __syncthreads();
    mid();
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        const int jm = js[i] & (ns - 1);
        const int d = (js[i] - jm) * R + jm;
#pragma unroll
        for (int r = 0; r < R; ++r) store(bs[i], d + r * ns, vr[i][r], vi[i][r]);
    }
}

// A pre(b, j, x_re, x_im) that leaves the values as they are.
struct NoPre {
    template <int R>
    __device__ __forceinline__ void operator()(int, int, float (&)[R], float (&)[R]) const {}
};

// A step between a pass's reads and its writes that does nothing.
struct NoSync {
    __device__ __forceinline__ void operator()() const {}
};

// f() on the last pass only.
template <typename F>
struct OnLast {
    F f;
    bool last;
    __device__ __forceinline__ void operator()() const {
        if (last) f();
    }
};

// All passes of the tile's transforms: radix 16 while four or more bits of
// L remain, then one pass of the remaining 2, 4 or 8. The first pass reads
// with gload (then applies gpre to each butterfly's values), the last
// writes with lstore; the passes between go through shared memory.
// last_to_smem: lstore writes shared memory too, so the last pass needs its
// barrier between reads and writes. first_in_smem: gload reads the shared
// memory the first pass writes, so that pass needs it too. last_read()
// runs after the last pass's reads (and barrier, if any), before its
// writes. tw: the pass table of length L (ops/cuda/vmemfft.py
// pass_twiddle_np), the blocks of the passes after the first in order.
template <bool COLS, typename GLoad, typename LStore, typename GPre, typename LastRead = NoSync>
__device__ __forceinline__ void fft_tile(const Layout<COLS>& lay, float* sr, float* si,
                                         GLoad gload, LStore lstore, GPre gpre,
                                         bool last_to_smem, const float2* __restrict__ tw,
                                         int sign, bool first_in_smem = false,
                                         LastRead last_read = LastRead{}) {
    const int npass = (lay.log_l + 3) / 4;
    int ns = 1, toff = 0;
#pragma unroll
    for (int p = 0; p < npass; ++p) {
        const bool first = p == 0, last = p == npass - 1;
        const int log_r = last ? lay.log_l - 4 * p : 4;
        auto load = [&](int b, int q, float& re, float& im) {
            if (first) {
                gload(b, q, re, im);
            } else {
                re = sr[lay.smem(b, q)];
                im = si[lay.smem(b, q)];
            }
        };
        auto store = [&](int b, int q, float re, float im) {
            if (last) {
                lstore(b, q, re, im);
            } else {
                sr[lay.smem(b, q)] = re;
                si[lay.smem(b, q)] = im;
            }
        };
        auto pre = [&](int b, int j, auto& xr, auto& xi) {
            if (first) gpre(b, j, xr, xi);
        };
        const bool exchange = first ? first_in_smem : !last || last_to_smem;
        const OnLast<LastRead> mid{last_read, last};
#define FFT_PASS(R) stockham_pass<R>(lay, load, store, pre, tw, toff, ns, sign, exchange, mid)
        switch (log_r) {
            case 1: FFT_PASS(2); break;
            case 2: FFT_PASS(4); break;
            case 3: FFT_PASS(8); break;
            default: FFT_PASS(16); break;
        }
#undef FFT_PASS
        if (!last) __syncthreads();
        if (ns > 1) toff += ((1 << log_r) - 1) * ns;
        ns <<= log_r;
    }
}

// W_n^(k1 j2) for the four-step at n = n1 x n2 from the tables
// A[k1, j2 mod 2^log_a] and B[k1, j2 >> log_a] (interleaved re, im; row
// strides 2^log_a and n2 >> log_a): the product of two float32 roundings.
__device__ __forceinline__ float2 four_step_twiddle(const float2* __restrict__ ta,
                                                    const float2* __restrict__ tb, int k1,
                                                    int j2, int log_a, int log_n2) {
    const float2 a = __ldg(ta + (static_cast<size_t>(k1) << log_a) + (j2 & ((1 << log_a) - 1)));
    const float2 b = __ldg(tb + (static_cast<size_t>(k1) << (log_n2 - log_a)) + (j2 >> log_a));
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Rows of length L = 2^log_l, B = 2^log_b of them per CTA. log_n1 == 0:
// rows [blockIdx.x B, +B) of (rows, L), transformed in place of their input
// layout (rows past the end are skipped). log_n1 > 0: the four-step leaf;
// row q = batch * n1 + k1 of the (rows, L) scratch holds k1's n2 = L values
// X[k1, j2], multiplied by W_n^(k1 j2) as they are loaded (see twiddle
// below), and Z[k1, k2] goes to out[batch * n + k1 + n1 * k2], n = n1 * L
// (B divides n1), through shared memory.
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
fft_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tw, const float2* __restrict__ ta,
                const float2* __restrict__ tb, const float2* __restrict__ ts, int log_a,
                long long rows, int log_l, int log_b, int log_n1, int sign, float scale) {
    extern __shared__ float smem[];
    const Layout<false> lay{log_l, log_b, row_stride(log_l)};
    const int B = 1 << log_b;
    float* sr = smem;
    float* si = smem + B * lay.S;
    const long long row0 = static_cast<long long>(blockIdx.x) << log_b;
    auto gload = [&](int b, int q, float& re, float& im) {
        const bool in = row0 + b < rows;
        const size_t g = (static_cast<size_t>(row0 + b) << log_l) + q;
        re = in ? xr[g] : 0.f;
        im = in ? xi[g] : 0.f;
    };
    if (log_n1 == 0) {
        auto gstore = [&](int b, int k, float re, float im) {
            if (row0 + b < rows) {
                const size_t g = (static_cast<size_t>(row0 + b) << log_l) + k;
                yr[g] = scale * re;
                yi[g] = scale * im;
            }
        };
        fft_tile(lay, sr, si, gload, gstore, NoPre{}, false, tw, sign);
        return;
    }
    // W_n^(k1 (j + r L/R)) = W_n^(k1 j) * S[k1, r] for the first pass's
    // butterfly j, r < R: two adjacent-j table reads and R broadcasts
    auto twiddle = [&](int b, int j, auto& pr, auto& pi) {
        constexpr int R = sizeof(pr) / sizeof(pr[0]);
        const int k1 = static_cast<int>((row0 + b) & ((1LL << log_n1) - 1));
        const float2 w0 = four_step_twiddle(ta, tb, k1, j, log_a, log_l);
        const float2* srow = ts + (k1 << 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float2 v = r == 0 ? make_float2(1.f, 0.f) : __ldg(srow + r);
            const float wr = w0.x * v.x - w0.y * v.y, wi = w0.x * v.y + w0.y * v.x;
            const float x_r = pr[r], x_i = pi[r];
            pr[r] = x_r * wr - x_i * wi;
            pi[r] = x_r * wi + x_i * wr;
        }
    };
    auto sstore = [&](int b, int k, float re, float im) {
        sr[lay.smem(b, k)] = re;
        si[lay.smem(b, k)] = im;
    };
    fft_tile(lay, sr, si, gload, sstore, twiddle, true, tw, sign);
    __syncthreads();
    const long long batch = row0 >> log_n1;
    const int k1_0 = static_cast<int>(row0 & ((1LL << log_n1) - 1));
    const size_t base = static_cast<size_t>(batch) << (log_n1 + log_l);
    const int T = blockDim.x;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {   // T * PER_THREAD == B * L
        const int e = threadIdx.x + i * T;
        const int b = e & (B - 1), k2 = e >> log_b;
        const size_t g = base + k1_0 + b + (static_cast<size_t>(k2) << log_n1);
        yr[g] = scale * sr[lay.smem(b, k2)];
        yi[g] = scale * si[lay.smem(b, k2)];
    }
}

// Four-step first pass for n = n1 * n2 (n1 = 2^log_n1, n2 = 2^log_n2): CTA
// blockIdx.x takes batch row blockIdx.x / (n2 / C) and columns
// [j2_0, j2_0 + C), C = 2^log_c, of its (n1, n2) matrix x[j1 n2 + j2]; it
// transforms each column over j1 and writes
// y[k1 n2 + j2] = sum_j1 x[j1 n2 + j2] W_n1^(j1 k1) (the leaf pass applies
// the twiddle W_n^(k1 j2)).
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
fft_front_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const float2* __restrict__ tw, int log_n1, int log_n2, int log_c, int sign) {
    extern __shared__ float smem[];
    const Layout<true> lay{log_n1, log_c, 0};
    float* sr = smem;
    float* si = smem + pidx(1 << (log_n1 + log_c));
    const int tiles = 1 << (log_n2 - log_c);
    const long long batch = blockIdx.x / tiles;
    const int j2_0 = (blockIdx.x % tiles) << log_c;
    const size_t base = (static_cast<size_t>(batch) << (log_n1 + log_n2)) + j2_0;
    auto gload = [&](int c, int j1, float& re, float& im) {
        const size_t off = (static_cast<size_t>(j1) << log_n2) + c;
        re = xr[base + off];
        im = xi[base + off];
    };
    auto gstore = [&](int c, int k1, float re, float im) {
        const size_t off = (static_cast<size_t>(k1) << log_n2) + c;
        yr[base + off] = re;
        yi[base + off] = im;
    };
    fft_tile(lay, sr, si, gload, gstore, NoPre{}, false, tw, sign);
}

int ilog2(long long v) {
    int l = 0;
    while ((1LL << (l + 1)) <= v) ++l;
    return l;
}

// The four-step leaf (log_n1 > 0) or the earlier single pass (log_n1 == 0)
// over (rows, 2^log_l) planes: the launch of fft_rows_f32 (fft.cu), whose
// comment gives the contract.
cudaError_t launch_rows(const float* xr, const float* xi, float* yr, float* yi, const float* tw,
                        const float* ta, const float* tb, const float* ts, int log_a,
                        long long rows, int log_l, int log_n1, int sign, float scale,
                        int device, cudaStream_t stream) {
    static size_t granted[64];
    int log_b = TILE_LOG2 - log_l;
    if (log_b < 0 || log_l < 1) return cudaErrorInvalidValue;
    if (log_n1 > 0 && (log_a < 0 || log_a > log_l)) return cudaErrorInvalidValue;
    if (log_n1 > 0) {
        if (log_b > log_n1) log_b = log_n1;                     // B divides n1
    } else {
        const int need = rows > 1 ? ilog2(rows - 1) + 1 : 0;   // B = np2(rows) at most
        if (log_b > need) log_b = need;
    }
    const long long B = 1LL << log_b;
    const long long ctas = (rows + B - 1) / B;
    const int threads = static_cast<int>((B << log_l) / PER_THREAD);
    if (ctas > 0x7fffffffLL || threads < 1) return cudaErrorInvalidValue;
    const size_t smem = 2 * sizeof(float) * static_cast<size_t>(B) * row_stride(log_l);
    RETURN_IF_ERROR(allow_smem(fft_rows_kernel, device, smem, granted));
    fft_rows_kernel<<<static_cast<unsigned>(ctas), threads, smem, stream>>>(
        xr, xi, yr, yi, reinterpret_cast<const float2*>(tw), reinterpret_cast<const float2*>(ta),
        reinterpret_cast<const float2*>(tb), reinterpret_cast<const float2*>(ts), log_a, rows,
        log_l, log_b, log_n1, sign, scale);
    return cudaGetLastError();
}

// The four-step's first pass over `batch` rows of n = 2^(log_n1 + log_n2):
// the launch of fft_front_f32 (fft.cu), whose comment gives the contract.
cudaError_t launch_front(const float* xr, const float* xi, float* yr, float* yi,
                         const float* tw, long long batch, int log_n1, int log_n2, int sign,
                         int device, cudaStream_t stream) {
    static size_t granted[64];
    int log_c = TILE_LOG2 - log_n1;
    if (log_c < 0 || log_n1 < 1) return cudaErrorInvalidValue;
    if (log_c > log_n2) log_c = log_n2;
    const long long ctas = batch << (log_n2 - log_c);
    const int threads = (1 << (log_c + log_n1)) / PER_THREAD;
    if (ctas > 0x7fffffffLL || threads < 1) return cudaErrorInvalidValue;
    const size_t smem = 2 * sizeof(float) * static_cast<size_t>(pidx(1 << (log_c + log_n1)));
    RETURN_IF_ERROR(allow_smem(fft_front_kernel, device, smem, granted));
    fft_front_kernel<<<static_cast<unsigned>(ctas), threads, smem, stream>>>(
        xr, xi, yr, yi, reinterpret_cast<const float2*>(tw), log_n1, log_n2, log_c, sign);
    return cudaGetLastError();
}

}  // namespace
