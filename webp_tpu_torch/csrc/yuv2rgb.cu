// Kernel K4: fancy (9:3:3:1) chroma upsampling + YUV -> RGB, cropped.
//
// Replaces webp_tpu/ops/jax_ops.py:189 fancy_yuv420_to_rgb with
// fancy_upsample (:149) and yuv_to_rgb (:139).  The JAX version builds the
// "far" chroma neighbours from shifted, repeated copies of the plane
// because gathers are slow on a TPU; here each thread reads its four
// chroma samples directly.
//
// Bound: memory.  Per output pixel it reads 1 luma byte and (cached) 8
// chroma bytes and writes 3 RGB bytes, with some 20 integer ops.  Design:
// one thread per output pixel, consecutive threads on consecutive pixels
// of a row, so the luma loads and RGB stores coalesce; the grid's y index
// is the image.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int mulhi(int v, int coeff) { return (v * coeff) >> 8; }

// out = (9*main + 3*far_col + 3*far_row + far_both + 8) >> 4, where the far
// sample lies on the side of the output pixel's parity, mirrored at the
// cropped chroma plane's edges (cw x ch).
__device__ __forceinline__ int upsample(const uint8_t* c, int stride, int i, int j, int ch, int cw) {
    const int ci = i >> 1, cj = j >> 1;
    const int fi = (i & 1) ? min(ci + 1, ch - 1) : max(ci - 1, 0);
    const int fj = (j & 1) ? min(cj + 1, cw - 1) : max(cj - 1, 0);
    return (9 * c[ci * stride + cj] + 3 * c[ci * stride + fj] + 3 * c[fi * stride + cj]
            + c[fi * stride + fj] + 8) >> 4;
}

__global__ void __launch_bounds__(kThreads) yuv2rgb_kernel(
    const uint8_t* __restrict__ y, long long y_bs, const uint8_t* __restrict__ u, long long u_bs,
    const uint8_t* __restrict__ v, long long v_bs, int mbw, int width, int height,
    uint8_t* __restrict__ rgb) {
    const int b = blockIdx.y;
    const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (idx >= static_cast<long long>(width) * height) return;
    const int i = static_cast<int>(idx / width), j = static_cast<int>(idx % width);
    const int ch = (height + 1) >> 1, cw = (width + 1) >> 1;
    const int cstride = mbw * 8;
    const int yy = y[b * y_bs + static_cast<long long>(i) * mbw * 16 + j];
    const int uu = upsample(u + b * u_bs, cstride, i, j, ch, cw);
    const int vv = upsample(v + b * v_bs, cstride, i, j, ch, cw);
    const int yv = mulhi(yy, 19077);
    const int r = (yv + mulhi(vv, 26149) - 14234) >> 6;
    const int g = (yv - mulhi(uu, 6419) - mulhi(vv, 13320) + 8708) >> 6;
    const int bl = (yv + mulhi(uu, 33050) - 17685) >> 6;
    uint8_t* out = rgb + (static_cast<long long>(b) * width * height + idx) * 3;
    out[0] = static_cast<uint8_t>(clip255(r));
    out[1] = static_cast<uint8_t>(clip255(g));
    out[2] = static_cast<uint8_t>(clip255(bl));
}

}  // namespace

WEBP_API int webp_yuv2rgb(const void* y, long long y_bs, const void* u, long long u_bs,
                          const void* v, long long v_bs, int mbw, int mbh, int width, int height,
                          int batch, void* rgb, void* stream) {
    if (width <= 0 || height <= 0 || batch <= 0) return 0;
    if (width > mbw * 16 || height > mbh * 16) return static_cast<int>(cudaErrorInvalidValue);
    const long long n = static_cast<long long>(width) * height;
    const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), batch);
    yuv2rgb_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), y_bs, static_cast<const uint8_t*>(u), u_bs,
        static_cast<const uint8_t*>(v), v_bs, mbw, width, height, static_cast<uint8_t*>(rgb));
    return static_cast<int>(cudaGetLastError());
}
