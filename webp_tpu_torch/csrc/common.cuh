// Shared helpers of the decode kernels.  Every entry point is a plain C
// function: device pointers and the stream arrive as void*, batch strides
// as long long (elements), and the return value is the cudaGetLastError()
// of the launch, which the Python wrapper turns into an exception.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WEBP_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// Anti-diagonal wavefront over the MB grid: MB (x, y) runs at step
// t = x + 2y, after its left, top-left, top and top-right neighbours.
__host__ __device__ __forceinline__ int wavefront_steps(int mbw, int mbh) {
    return mbw + 2 * (mbh - 1);
}

// Threads of a wavefront block: one warp per MB row, at most 32 warps.
inline int wavefront_threads(int mbh) { return 32 * (mbh < 32 ? mbh : 32); }
