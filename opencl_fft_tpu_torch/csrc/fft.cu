// Batched complex FFT of float32 split planes on Hopper (sm_90a).
//
// Replaces the TPU kernels of opencl_fft_tpu/ops/pallas/vmemfft.py:
//   fft_vmem         (vmemfft.py:1100; _build / _build2 / _build3h / _build_sl)
//   fft_vmem_front2  (vmemfft.py:808; _build_front2, two in-kernel levels + leaf)
// Both compute out = scale * DFT_sign(x) over the last axis of (rows, n)
// split re/im planes, sign = -1 forward (exp(-2 pi i jk/n)), +1 the
// unnormalized inverse. The TPU kernels are bf16x3 matmul levels on the MXU;
// here the butterflies are plain float32, which is exact enough, and the
// transform is memory-bound.
//
// What bounds it on the card. 5 n log2 n operations per row against 16 n
// bytes of planes in and out: at n = 2^18 that is 0.024 GFLOP for 2 MB, so
// one read and one write of the planes over device memory is the floor
// (bytes, not operations). Every extra pass over device memory adds the
// whole floor again.
//
// What the design does about it. Every pass reads the planes once and
// writes them once, coalesced, and keeps all butterflies on chip. A CTA
// owns a tile of up to 2^13 values (2^14 in the single pass at 2^14) and
// runs Stockham passes of radix 16 (the last one of radix 2, 4 or 8 when
// the length is not a power of 16): each thread holds 16 values in
// registers and does its butterfly there, exchanging through shared memory
// between passes. The kernels (ops/cuda/vmemfft.py:route picks them by n):
//   fft_rows_pipe_kernel  n <= 2^14: the single pass over device memory.
//                       Persistent CTAs walk tiles of whole rows; a bulk
//                       asynchronous copy refills a CTA's stage with its
//                       next tile once the last pass has read it, while
//                       the other CTAs of the SM compute.
//   fft_rows_kernel     the leaf of the two passes (B whole rows a CTA,
//                       two CTAs an SM); at n1 = 1 the earlier single pass,
//                       which loads through registers with no overlap
//                       inside a CTA (chip_smoke.py times the pipelined
//                       kernel against it).
//   fft_front_kernel    n > 2^14, with the leaf: the four-step at n = n1 x
//                       n2 (256 x n/256 up to 2^18, 1024 x n/1024 above).
//                       The front pass transforms C = 2^13 / n1 adjacent
//                       columns of the (n1, n2) matrix a CTA (32 columns,
//                       128-byte segments, at n1 = 256); the leaf pass
//                       multiplies each row value by W_n^(k1 j2) as it
//                       loads it, transforms the rows and stores them
//                       transposed to out[k1 + n1 k2] through shared memory.
// A thread-block-cluster kernel that held a 2^14..2^18 transform in
// distributed shared memory, so the planes crossed device memory once, lost
// to the two passes at every size on the H100 (PERF.md, section 6): its two
// exchanges moved every value through DSMEM at about the cost of a pass
// over device memory, and at 2^18 only 7 clusters of 16 CTAs fit at once.
// Twiddles come from float32 tables built in float64 on the host (angles
// reduced mod n in integers): W_L^(r k) for the Stockham passes, laid out
// pass by pass so that a warp reads adjacent entries (see stockham_pass);
// for the four-step W_n^(k1 j2) from two (n1, ~sqrt(n2)) tables A and B
// and a (n1, 16) step table S, never an n-sized one. The constants inside
// a radix-8/16 butterfly are W_16^m. Shared memory pads one float per 32
// (p -> p + p/32) against bank conflicts of the strided Stockham writes;
// rows of a row tile sit at an odd stride. All
// offsets into the planes are 64-bit. The tile, the leaf and front kernels
// and their launchers are in fft_tile.cuh, which streamstep.cu shares; this
// file holds the single pass and the C entries.

#include "fft_tile.cuh"

namespace {

// The single pass reaches 2^14: a CTA of 1024 threads holds one row (135
// KB of shared memory with the padding). Shorter rows go 2^PIPE_TILE_LOG2
// values (whole rows) a CTA: smaller tiles put more CTAs on an SM, each
// loading while the others compute. Chosen by timing 2^11-, 2^12- and
// 2^13-value tiles at 2^10..2^12 on the H100 (8, 4 and 2 CTAs an SM): 2^11
// was fastest at 2^10 and 2^11.
constexpr int PIPE_TILE_LOG2 = 11;

// The single pass at 2^log_l points: tiles of 2^pipe_log_b(log_l) rows,
// a stage of pipe_stage_floats(log_l) floats a plane (the padded rows,
// rounded up to 128 bytes).
__host__ __device__ constexpr int pipe_log_b(int log_l) {
    return log_l < PIPE_TILE_LOG2 ? PIPE_TILE_LOG2 - log_l : 0;
}

__host__ __device__ constexpr int pipe_stage_floats(int log_l) {
    return ((row_stride(log_l) << pipe_log_b(log_l)) + 31) & ~31;
}

// The single pass's bulk copies: one thread fills a stage with a tile's
// rows by two 1-D asynchronous copies (the re and im planes), which
// complete on the stage's mbarrier; the threads wait on its phase parity.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Load rows [row0, row0 + count) of (rows, 2^log_l) planes into a stage
// (re at sr, im at si), unpadded: element (b, p) at b 2^log_l + p.
__device__ __forceinline__ void load_tile(float* sr, float* si, const float* xr,
                                          const float* xi, long long row0, long long count,
                                          int log_l, uint64_t* bar) {
    const unsigned bytes = static_cast<unsigned>(count << log_l) * sizeof(float);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(2 * bytes)
                 : "memory");
    const size_t off = static_cast<size_t>(row0) << log_l;
    bulk_load(sr, xr + off, bytes, bar);
    bulk_load(si, xi + off, bytes, bar);
}

// The single pass: rows of length L = 2^log_l, transformed in place of
// their layout, by persistent CTAs that walk tiles of B = 2^log_b whole
// rows (tile t: rows [t B, t B + B), the last one short) grid-stride, as
// many CTAs as fit on the card at once (8 an SM at 2^11-value tiles, 2 at
// 2^13, 1 at 2^14 and 1024 threads). A CTA's tile sits in one stage of
// shared memory, filled by a bulk copy: the first pass reads the unpadded
// stage (a warp's reads are contiguous: no bank conflicts) and writes it
// back in the padded layout; once the last pass has read it, the stage
// takes the copy of the CTA's next tile while the last butterflies run and
// their results go to device memory from registers (each warp store 128
// contiguous bytes). So an SM's stages are the pipeline: some load while
// others compute. (On the H100 this beat one CTA an SM with two stages,
// whose barriers left the SM without other work, and a ring of three
// stages shared by two groups of threads, which spilled.) The kernel is
// bound by its instruction count more than by device memory (at 2^13 it
// takes nearly as long on planes in L2), so it is built once per length:
// with LOG_L a constant the passes unroll and their strides and offsets
// fold.
// The stage holds pipe_stage_floats(LOG_L) floats a plane; the mbarrier
// follows it.
template <int LOG_L>
__global__ void __launch_bounds__(2 * MAX_THREADS, 1)
fft_rows_pipe_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                     float* __restrict__ yr, float* __restrict__ yi,
                     const float2* __restrict__ tw, long long rows, int sign, float scale) {
    constexpr int LOG_B = pipe_log_b(LOG_L);
    constexpr int STAGE = pipe_stage_floats(LOG_L);
    extern __shared__ __align__(128) float smem[];
    float* sr = smem;
    float* si = smem + STAGE;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * STAGE);
    const Layout<false> lay{LOG_L, LOG_B, row_stride(LOG_L)};
    constexpr long long B = 1LL << LOG_B;
    const long long tiles = (rows + B - 1) >> LOG_B;
    auto fill = [&](long long tile) {
        const long long row0 = tile << LOG_B;
        load_tile(sr, si, xr, xi, row0, rows - row0 < B ? rows - row0 : B, LOG_L, full);
    };
    if (threadIdx.x == 0) {
        barrier_init(full);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        fill(blockIdx.x);
    }
    __syncthreads();
    unsigned parity = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, parity ^= 1) {
        barrier_wait(full, parity);
        const long long row0 = tile << LOG_B;
        auto sload = [&](int b, int q, float& re, float& im) {
            re = sr[(b << LOG_L) + q];
            im = si[(b << LOG_L) + q];
        };
        auto gstore = [&](int b, int k, float re, float im) {
            if (row0 + b < rows) {
                const size_t g = (static_cast<size_t>(row0 + b) << LOG_L) + k;
                yr[g] = scale * re;
                yi[g] = scale * im;
            }
        };
        // the stage is read: every thread's shared accesses are ordered
        // before the copy that refills it with the CTA's next tile
        auto refill = [&] {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncthreads();
            if (threadIdx.x == 0 && tile + gridDim.x < tiles) fill(tile + gridDim.x);
        };
        fft_tile(lay, sr, si, sload, gstore, NoPre{}, false, tw, sign, true, refill);
    }
}

// Make `device` current unless it is already (the wrappers call on the
// current device; cudaSetDevice costs a CUDA API call each time).
cudaError_t use_device(int device) {
    int current = -1;
    RETURN_IF_ERROR(cudaGetDevice(&current));
    return current == device ? cudaSuccess : cudaSetDevice(device);
}

// The single pass at 2^LOG_L points on `stream`, as many persistent CTAs
// as the card holds at once (its SMs times the occupancy, read once per
// device).
template <int LOG_L>
cudaError_t launch_pipe(const float* xr, const float* xi, float* yr, float* yi,
                        const float* tw, long long rows, int sign, float scale, int device,
                        cudaStream_t stream) {
    static size_t granted[64];
    static int resident[64];
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    constexpr int threads = (1 << (LOG_L + pipe_log_b(LOG_L))) / PER_THREAD;
    constexpr size_t smem = sizeof(float) * 2 * pipe_stage_floats(LOG_L) + sizeof(uint64_t);
    RETURN_IF_ERROR(allow_smem(fft_rows_pipe_kernel<LOG_L>, device, smem, granted));
    if (resident[device] == 0) {
        int sms = 0, per_sm = 0;
        RETURN_IF_ERROR(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
        RETURN_IF_ERROR(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fft_rows_pipe_kernel<LOG_L>, threads, smem));
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        resident[device] = sms * per_sm;
    }
    const long long tiles = ((rows - 1) >> pipe_log_b(LOG_L)) + 1;
    const unsigned ctas =
        static_cast<unsigned>(tiles < resident[device] ? tiles : resident[device]);
    fft_rows_pipe_kernel<LOG_L><<<ctas, threads, smem, stream>>>(
        xr, xi, yr, yi, reinterpret_cast<const float2*>(tw), rows, sign, scale);
    return cudaGetLastError();
}

}  // namespace

// The single pass: transforms of length 2^log_l, log_l in [10, 14] (one
// kernel each), along the rows of (rows, 2^log_l) split planes x -> y,
// times scale, y in x's layout; any rows >= 1. tw: the pass table of length
// 2^log_l, (re, im) interleaved, sign baked in. x's planes must be 16-byte
// aligned (the bulk copies). Same pointer and stream contract as
// fft_rows_f32.
extern "C" int fft_rows_pipe_f32(const float* xr, const float* xi, float* yr, float* yi,
                                 const float* tw, long long rows, int log_l, int sign,
                                 float scale, int device, void* stream_ptr) {
    RETURN_IF_ERROR(use_device(device));
    if (rows < 1) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(xi)) & 15)
        return cudaErrorMisalignedAddress;
    cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
    switch (log_l) {
        case 10: return launch_pipe<10>(xr, xi, yr, yi, tw, rows, sign, scale, device, st);
        case 11: return launch_pipe<11>(xr, xi, yr, yi, tw, rows, sign, scale, device, st);
        case 12: return launch_pipe<12>(xr, xi, yr, yi, tw, rows, sign, scale, device, st);
        case 13: return launch_pipe<13>(xr, xi, yr, yi, tw, rows, sign, scale, device, st);
        case 14: return launch_pipe<14>(xr, xi, yr, yi, tw, rows, sign, scale, device, st);
        default: return cudaErrorInvalidValue;
    }
}

// Transforms of length 2^log_l along the rows of (rows, 2^log_l) split
// planes x -> y, times scale. log_n1 == 0: y has x's layout (the earlier
// single pass; rows need not divide the CTA's row count). log_n1 > 0:
// the four-step leaf after fft_front_f32; x is its (batch * n1, n2)
// scratch, rows = batch * n1, and y[batch n + k1 + n1 k2] = scale *
// Z[k1, k2], Z the transforms of the rows times W_n^(k1 j2), j2 = j + r L/R,
// as W_n^(k1 j) S[k1, r] with W_n^(k1 j) = A[k1, j mod 2^log_a]
// B[k1, j >> log_a] (ta, tb, ts: A (n1, 2^log_a), B (n1, L / 2^log_a) and S
// (n1, 16), S[k1, r] = W_n^(k1 r L/R) for the first pass's radix R =
// min(16, L); unused at log_n1 == 0). tw: the pass table of length L.
// Tables (re, im) interleaved, sign baked in. All pointers are float32
// device memory on `device`. Launches on `stream` without synchronising;
// returns the first CUDA error.
extern "C" int fft_rows_f32(const float* xr, const float* xi, float* yr, float* yi,
                            const float* tw, const float* ta, const float* tb,
                            const float* ts, int log_a, long long rows, int log_l,
                            int log_n1, int sign, float scale, int device,
                            void* stream_ptr) {
    RETURN_IF_ERROR(use_device(device));
    return launch_rows(xr, xi, yr, yi, tw, ta, tb, ts, log_a, rows, log_l, log_n1, sign, scale,
                       device, static_cast<cudaStream_t>(stream_ptr));
}

// Four-step first pass over `batch` rows of n = 2^(log_n1 + log_n2):
// y[k1 n2 + j2] = sum_j1 x[j1 n2 + j2] W_n1^(j1 k1) per row; the leaf
// pass (fft_rows_f32 at log_n1) applies the twiddles. tw: the pass table of
// length n1, (re, im) interleaved, sign baked in. Same pointer and stream
// contract as fft_rows_f32.
extern "C" int fft_front_f32(const float* xr, const float* xi, float* yr, float* yi,
                             const float* tw, long long batch, int log_n1, int log_n2,
                             int sign, int device, void* stream_ptr) {
    RETURN_IF_ERROR(use_device(device));
    return launch_front(xr, xi, yr, yi, tw, batch, log_n1, log_n2, sign, device,
                        static_cast<cudaStream_t>(stream_ptr));
}
