// Token contexts of the encode's level arrays, shared by K6 (token
// statistics) and K13 (coefficient partitions): a block's initial context
// is the number of its top and left neighbour blocks (across MB edges too,
// 0 outside the frame) that carry a nonzero level, as the host writer's
// `encode/contexts.py` computes them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// One image's level arrays: luma modes [nmb], levels [nmb][16],
// [nmb][16][16], [nmb][8][16].
struct Levels {
    const uint8_t* lmode;
    const int16_t *y2, *y, *uv;
};

static __device__ __forceinline__ bool any_nz(const int16_t* blk, int from) {
    bool nz = false;
    for (int k = from; k < 16; ++k) nz |= blk[k] != 0;
    return nz;
}

// Nonzero flag of luma block s of MB m as the contexts see it: the AC
// levels only when the MB has a Y2 block.
static __device__ __forceinline__ int y_nz(const Levels& L, int m, int s) {
    return any_nz(L.y + (m * 16 + s) * 16, L.lmode[m] != 4 ? 1 : 0);
}

static __device__ __forceinline__ int uv_nz(const Levels& L, int m, int s) {
    return any_nz(L.uv + (m * 8 + s) * 16, 0);
}

// Y2 nonzero flag of the nearest MB at m - k * step (k >= 1, `count`
// candidates) that has a Y2 block, 0 when there is none.
static __device__ int y2_ctx_walk(const Levels& L, int m, int step, int count) {
    for (int k = 1; k <= count; ++k) {
        const int n = m - k * step;
        if (L.lmode[n] != 4) return any_nz(L.y2 + n * 16, 0);
    }
    return 0;
}

// Context of MB m's (at column mx, row my) Y2 block: the nearest MBs with
// a Y2 block above it and left of it.
static __device__ __forceinline__ int y2_ctx(const Levels& L, int m, int mx, int my, int mbw) {
    return y2_ctx_walk(L, m, mbw, my) + y2_ctx_walk(L, m, 1, mx);
}

// Context of luma block s (raster in the MB) of MB m.
static __device__ __forceinline__ int y_ctx(const Levels& L, int m, int s, int mx, int my,
                                            int mbw) {
    const int sy = s >> 2, sx = s & 3;
    return (sy > 0 ? y_nz(L, m, s - 4) : (my > 0 ? y_nz(L, m - mbw, 12 + sx) : 0))
           + (sx > 0 ? y_nz(L, m, s - 1) : (mx > 0 ? y_nz(L, m - 1, 4 * sy + 3) : 0));
}

// Context of chroma block s (4 U then 4 V, raster in their 2x2) of MB m.
static __device__ __forceinline__ int uv_ctx(const Levels& L, int m, int s, int mx, int my,
                                             int mbw) {
    const int ch = s >> 2, q = s & 3, qy = q >> 1, qx = q & 1;
    return (qy > 0 ? uv_nz(L, m, s - 2) : (my > 0 ? uv_nz(L, m - mbw, ch * 4 + 2 + qx) : 0))
           + (qx > 0 ? uv_nz(L, m, s - 1) : (mx > 0 ? uv_nz(L, m - 1, ch * 4 + 2 * qy + 1) : 0));
}
