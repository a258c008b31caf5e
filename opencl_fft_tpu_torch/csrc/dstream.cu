// Whole-scan direct FIR convolution on Hopper (sm_90a).
//
// Replaces the TPU kernel opencl_fft_tpu/ops/pallas/dstream.py:_dstream_kernel
// (wrapper dstream_steps). The TPU kernel multiplies the last P+1 input
// blocks by constant block-Toeplitz slabs, out_g = [x_{g-P} .. x_g] @ T, in
// a sequential grid that carries the previous P blocks in VMEM scratch.
// With the P context blocks and the nb new blocks laid end to end in one
// sequence s (length (P+nb)*vsize) and k the time-reversed taps, that is a
// plain valid correlation, blocks and all:
//     out[t] = sum_{h < irsize} s[t + c + h] * k[h],   t < nb*vsize,
// c = P*vsize - irsize + off (off 1 for the standard alignment, 0 for
// delay_compat). Nothing carries from block to block.
//
// What bounds it on the card. 2 * nb*vsize * irsize FP32 operations (0.986
// GFLOP at 1880 blocks of 512, 512 taps) on ~8 MB of data: the FMA pipes,
// not memory. A dense Toeplitz GEMM does twice the work (half of T is
// structural zeros) and wants both operands from memory for every product.
//
// What the design does about it. A register-blocked direct FIR on the FP32
// pipes, the taps' work only. A CTA of 128 threads owns 2560 contiguous
// outputs; it stages its input window and up to 1000 taps at a time in
// shared memory. Each thread computes R = 20 adjacent outputs from a
// register window of 40 samples held as two 20-sample halves: per chunk of
// 20 taps it loads the next 20 samples into the half it no longer needs and
// the taps as five float4 broadcasts, then does 400 FMAs from registers,
// 20 independent accumulators deep; the halves swap roles every chunk, so
// the window never moves between registers. R = 20 (not 16) puts the
// 962,560 outputs of 1880 blocks of 512 in 376 CTAs, 2.85 a SM, so the
// busiest of the SMs' four schedulers runs 3 warps against a mean of 2.85
// (at R = 16: 4 against 3.56). The window is stored with one pad word per
// 32 samples, so the 32 threads of a warp (20 samples apart) meet at most
// two to a bank. Taps past irsize are zero in shared memory, so only the
// last two chunks of a tap block do any padded work (8 taps in 520 at 512
// taps). The sum over h runs in ascending order, one FMA each:
// deterministic, no atomics.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int R = 20;                  // outputs a thread, and taps a chunk
constexpr int THREADS = 128;
constexpr int TILE = R * THREADS;      // outputs a CTA
constexpr int HB = 50 * R;             // taps staged at a time (whole chunk pairs)
constexpr int WIN = TILE + HB + R;     // window samples staged at a time

__host__ __device__ __forceinline__ int widx(int j) { return j + (j >> 5); }

constexpr int WIN_WORDS = WIN + WIN / 32 + 1;

// acc[r] += sum_{i < R} w[r + i] * k[i], w = [lo, hi]: one chunk of R taps
// over the R outputs (the window index r + i is fixed at compile time).
__device__ __forceinline__ void fir_chunk(float (&acc)[R], const float (&lo)[R],
                                          const float (&hi)[R], const float* __restrict__ k) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
        const float4 k4 = *reinterpret_cast<const float4*>(k + 4 * q);
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int m = r + 4 * q + i;
                acc[r] = fmaf(m < R ? lo[m] : hi[m - R], kk[i], acc[r]);
            }
    }
}

// out[t] = sum_{h < irsize} s[t + c + h] * ir[irsize - 1 - h], t < nout;
// s holds slen samples (every index read is < slen).
__global__ void __launch_bounds__(THREADS)
dstream_fir_kernel(const float* __restrict__ s, long long slen, const float* __restrict__ ir,
                   int irsize, int c, float* __restrict__ out, long long nout) {
    __shared__ __align__(16) float xs[WIN_WORDS];
    __shared__ __align__(16) float ks[HB];
    const long long t0 = static_cast<long long>(blockIdx.x) * TILE;
    const int n0 = threadIdx.x * R;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;

    for (int hb0 = 0; hb0 < irsize; hb0 += HB) {
        const int hn = min(HB, irsize - hb0);
        const int hpad = (hn + 2 * R - 1) / (2 * R) * (2 * R);
        const long long base = t0 + c + hb0;
        const int wn = TILE + hpad + R;       // samples this tap block reads
        __syncthreads();                      // the previous block's reads are done
        for (int j = threadIdx.x; j < wn; j += THREADS) {
            const long long g = base + j;
            xs[widx(j)] = g < slen ? __ldg(s + g) : 0.f;
        }
        for (int h = threadIdx.x; h < hpad; h += THREADS)
            ks[h] = h < hn ? __ldg(ir + (irsize - 1 - hb0 - h)) : 0.f;
        __syncthreads();

        float a[R], b[R];
#pragma unroll
        for (int m = 0; m < R; ++m) a[m] = xs[widx(n0 + m)];
        for (int h0 = 0; h0 < hpad; h0 += 2 * R) {
#pragma unroll
            for (int m = 0; m < R; ++m) b[m] = xs[widx(n0 + h0 + R + m)];
            fir_chunk(acc, a, b, ks + h0);
#pragma unroll
            for (int m = 0; m < R; ++m) a[m] = xs[widx(n0 + h0 + 2 * R + m)];
            fir_chunk(acc, b, a, ks + h0 + R);
        }
    }

    const long long t = t0 + n0;
    if (t + R <= nout) {
#pragma unroll
        for (int q = 0; q < R / 4; ++q)
            *reinterpret_cast<float4*>(out + t + 4 * q) =
                make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
            if (t + r < nout) out[t + r] = acc[r];
    }
}

}  // namespace

// One direct-FIR scan of nb blocks: seq ((p+nb), vsize) the p =
// ceil(irsize / vsize) context blocks, oldest first, then the nb new blocks;
// ir (irsize,) the coefficients in time order; outs (nb, vsize), 16-byte
// aligned. off is 1 for the standard alignment, 0 for delay_compat. All
// pointers are float32 device memory on `device`. Launches on `stream`
// without synchronising; returns the first CUDA error.
extern "C" int dstream_steps_f32(const float* seq, const float* ir, float* outs, int nb,
                                 int irsize, int vsize, int off, int device,
                                 void* stream_ptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (nb < 1 || irsize < 1 || vsize < 1 || (off != 0 && off != 1))
        return cudaErrorInvalidValue;
    const long long p = (irsize + vsize - 1) / vsize;
    const long long nout = static_cast<long long>(nb) * vsize;
    const long long ctas = (nout + TILE - 1) / TILE;
    if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int c = static_cast<int>(p * vsize - irsize + off);
    dstream_fir_kernel<<<static_cast<unsigned>(ctas), THREADS, 0,
                         static_cast<cudaStream_t>(stream_ptr)>>>(
        seq, (p + nb) * vsize, ir, irsize, c, outs, nout);
    return cudaGetLastError();
}
