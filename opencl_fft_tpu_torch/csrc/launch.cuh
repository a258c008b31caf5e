// Host-side launch helpers shared by the kernel sources (fft_tile.cuh,
// scan_mac.cuh and the sources that include them).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Return the CUDA error of `expr` from the enclosing function if it failed.
#define RETURN_IF_ERROR(expr)                    \
    do {                                         \
        const cudaError_t err_ = (expr);         \
        if (err_ != cudaSuccess) return err_;    \
    } while (0)

namespace {

__host__ __device__ inline int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// Raise a kernel's dynamic shared memory limit once per device and size.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, size_t bytes, size_t (&granted)[64]) {
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (bytes <= 48 * 1024 || bytes <= granted[device]) return cudaSuccess;
    RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes)));
    granted[device] = bytes;
    return cudaSuccess;
}

}  // namespace
