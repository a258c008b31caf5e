// Whole-scan direct FIR convolution on Hopper (sm_90a).
//
// Replaces the TPU kernel opencl_fft_tpu/ops/pallas/dstream.py:_dstream_kernel
// (wrapper dstream_steps). Each output block is a block-Toeplitz product of
// the last P+1 input blocks against constant (vsize, vsize) slabs built once
// per scan from the coefficients:
//     out_g = [x_{g-P} .. x_g] @ T,   T stacked as ((P+1)*vsize, vsize).
// The TPU kernel walks groups of 8 blocks in a sequential grid and carries
// the previous P blocks in VMEM scratch.
//
// What bounds it on the card. At 512 taps @ vsize 512 (P = 1) and 1880
// blocks, the dense product is nb * (P+1)*vsize * vsize * 2 ~ 2.0 GFLOP of
// FP32 (half of T is structural zeros, so the FIR itself needs ~1.0) on
// ~10 MB of data: FP32 FMA throughput, not memory.
//
// What the design does about it. The carry dissolves: the caller lays the
// P context blocks and the nb new blocks end to end in one buffer
// seq = [context; blocks], so row g of the A operand, [x_{g-P} .. x_g], is
// seq read from g*vsize for (P+1)*vsize samples: A is seq with row stride
// vsize (the same overlapping-row trick as the overlap-add in
// streamstep.cu). The whole scan is then one launch of the shared tiled
// SGEMM (sgemm_tile.cuh), all blocks in parallel.

#include "sgemm_tile.cuh"

namespace {

using sgemm::BM;
using sgemm::BN;
using sgemm::TM;
using sgemm::TN;
constexpr int GEMM_THREADS = sgemm::THREADS;

// outs (nb, v) = A (nb, (P+1)v; row g = seq[g*v, g*v + (P+1)v)) @ slabs
__global__ void __launch_bounds__(GEMM_THREADS)
dstream_gemm_kernel(int nb, int vsize, int kdim, const float* __restrict__ seq,
                    const float* __restrict__ slabs, float* __restrict__ outs) {
    const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
    float acc[TM][TN];
    sgemm::gemm_tile(nb, vsize, kdim, seq, vsize, slabs, vsize, row0, col0, acc);
    const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty * TM + i;
        if (r >= nb) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = col0 + tx * TN + j;
            if (c < vsize) outs[static_cast<size_t>(r) * vsize + c] = acc[i][j];
        }
    }
}

}  // namespace

// One direct-FIR scan of nb blocks: seq ((p+nb), vsize) the p context
// blocks, oldest first, then the nb new blocks; slabs ((p+1)*vsize, vsize);
// outs (nb, vsize). All pointers are float32 device memory on `device`.
// Launches on `stream` without synchronising; returns the first CUDA error.
extern "C" int dstream_steps_f32(const float* seq, const float* slabs, float* outs,
                                 int nb, int p, int vsize, int device, void* stream_ptr) {
    SGEMM_RETURN_IF_ERROR(cudaSetDevice(device));
    dstream_gemm_kernel<<<dim3(sgemm::cdiv(nb, BM), sgemm::cdiv(vsize, BN)), GEMM_THREADS,
                          0, static_cast<cudaStream_t>(stream_ptr)>>>(
        nb, vsize, (p + 1) * vsize, seq, slabs, outs);
    return cudaGetLastError();
}
