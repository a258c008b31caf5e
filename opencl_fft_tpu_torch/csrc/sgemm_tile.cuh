// Shared-memory tiled FP32 FMA SGEMM tile, shared by the streaming kernels
// (streamstep.cu, splitstep.cu).
//
// One 256-thread block computes a 64x64 tile of C = A @ B; each thread holds
// 4x4 outputs in registers. gemm_tile reads A with an arbitrary row stride,
// which the callers use to read overlapping rows of one buffer as a matrix
// (the overlap-add in streamstep.cu); gemm_tile_ld takes a loader a(row, col) for each operand, so
// a caller can compute A's elements as they are loaded (splitstep.cu's
// prescaled row stacks, never stored). Plain FP32 FMA, no TF32: the
// transform tables are exact in float32 only, and the JAX package runs
// them at Precision.HIGHEST.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace sgemm {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

inline int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// acc = the (BM x BN) tile at (row0, col0) of A (M x K) @ B (K x N), the
// operands read through the loaders a(row, col) and b(row, col) (entries
// outside the matrices are not read); thread (ty, tx) holds rows ty*TM..,
// cols tx*TN..
template <class ALoad, class BLoad>
__device__ __forceinline__ void gemm_tile_ld(int M, int N, int K, const ALoad& a,
                                             const BLoad& b, int row0, int col0,
                                             float (&acc)[TM][TN]) {
    __shared__ __align__(16) float As[BK][BM + 4];   // k-major: As[k][m]
    __shared__ __align__(16) float Bs[BK][BN + 4];
    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int i = tid; i < BM * BK; i += THREADS) {
            const int m = i / BK, k = i % BK;
            const int gm = row0 + m, gk = k0 + k;
            As[k][m] = (gm < M && gk < K) ? a(gm, gk) : 0.f;
        }
        for (int i = tid; i < BK * BN; i += THREADS) {
            const int k = i / BN, n = i % BN;
            const int gk = k0 + k, gn = col0 + n;
            Bs[k][n] = (gk < K && gn < N) ? b(gk, gn) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 av4 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
            const float4 bv4 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
            const float av[TM] = {av4.x, av4.y, av4.z, av4.w};
            const float bv[TN] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
}

// A row-major matrix with row stride ld, read through the read-only cache.
struct Strided {
    const float* p;
    int ld;
    __device__ __forceinline__ float operator()(int r, int c) const {
        return __ldg(p + static_cast<size_t>(r) * ld + c);
    }
};

// acc = the (BM x BN) tile at (row0, col0) of A (M x K, row stride lda) @
// B (K x N, row stride ldb)
__device__ __forceinline__ void gemm_tile(int M, int N, int K,
                                          const float* __restrict__ A, int lda,
                                          const float* __restrict__ B, int ldb,
                                          int row0, int col0,
                                          float (&acc)[TM][TN]) {
    gemm_tile_ld(M, N, K, Strided{A, lda}, Strided{B, ldb}, row0, col0, acc);
}

}  // namespace sgemm

// Return the CUDA error of `expr` from the enclosing function if it failed.
#define SGEMM_RETURN_IF_ERROR(expr)                     \
    do {                                                \
        const cudaError_t err_ = (expr);                \
        if (err_ != cudaSuccess) return err_;           \
    } while (0)
