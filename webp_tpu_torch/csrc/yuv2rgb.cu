// Kernel K4: fancy (9:3:3:1) chroma upsampling + YUV -> RGB, cropped.
//
// Replaces webp_tpu/ops/jax_ops.py:189 fancy_yuv420_to_rgb with
// fancy_upsample (:149) and yuv_to_rgb (:139).  The JAX version builds the
// "far" chroma neighbours from shifted, repeated copies of the plane
// because gathers are slow on a TPU; here each thread reads the chroma
// window its pixels share once.
//
// Bound: the integer operations of the conversion (some 25 a pixel) and
// the bytes (1 luma, 3 RGB and a quarter of each chroma sample a pixel).
// Design: a thread takes output rows 2k and 2k+1 at a run of kRun output
// columns.  Those pixels read chroma rows k-1, k and k+1 at columns
// c0-1 .. c0+kRun/2 (c0 = kRun/2 * run), each mirrored into the cropped
// plane exactly as the JAX version's edges: the thread loads that window
// of U and of V once (a 4-byte load and two bytes a row), folds each
// column's vertical taps (3 * near + far, per output row parity), and
// forms every pixel as (3 * a[main] + a[far] + 8) >> 4.  Luma comes in as
// one 8-byte load a row, RGB goes out as 8-byte stores where the row's
// address allows (a width that is a multiple of 8), else as bytes.  All
// index math is 32-bit from blockIdx and threadIdx; a CTA is kRunsX runs
// of kPairsY row pairs, the grid's z the image.

#include "common.cuh"

namespace {

constexpr int kRun = 8;       // output columns a thread takes (in two rows)
constexpr int kHalf = kRun / 2;
constexpr int kWin = kHalf + 2;  // chroma columns a run reads
constexpr int kRunsX = 32;
constexpr int kPairsY = 4;

__device__ __forceinline__ int mulhi(int v, int coeff) { return (v * coeff) >> 8; }

// Chroma row `row` at columns c0-1 .. c0+kHalf, mirrored into [0, cw):
// column -1 repeats column 0, columns past cw-1 repeat column cw-1.  c0 <
// cw, and columns c0 .. c0+kHalf-1 lie in the MB-padded row.
template <bool kVec>
__device__ __forceinline__ void window(const uint8_t* __restrict__ row, int c0, int cw, int* s) {
    if (kVec) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(row + c0);
#pragma unroll
        for (int i = 0; i < kHalf; ++i) s[1 + i] = (w >> (8 * i)) & 0xff;
    } else {
#pragma unroll
        for (int i = 0; i < kHalf; ++i) s[1 + i] = row[c0 + i];
    }
    s[0] = c0 > 0 ? row[c0 - 1] : s[1];
    s[kWin - 1] = c0 + kHalf < cw ? row[c0 + kHalf] : 0;
#pragma unroll
    for (int i = 2; i < kWin; ++i)
        if (c0 - 1 + i >= cw) s[i] = s[i - 1];
}

// The vertical taps of one plane for both output rows: a[p][i] = 3 *
// chroma(k, i) + chroma(far row of parity p, i).
template <bool kVec>
__device__ __forceinline__ void taps(const uint8_t* __restrict__ c, int stride, int k, int ch,
                                     int c0, int cw, int (*a)[kWin]) {
    int near[kWin], prev[kWin], next[kWin];
    window<kVec>(c + k * stride, c0, cw, near);
    window<kVec>(c + max(k - 1, 0) * stride, c0, cw, prev);
    window<kVec>(c + min(k + 1, ch - 1) * stride, c0, cw, next);
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
        a[0][i] = 3 * near[i] + prev[i];
        a[1][i] = 3 * near[i] + next[i];
    }
}

// Output pixel q of the run (parity p row): main column q/2, far column
// the one on q's side.
__device__ __forceinline__ int upsampled(const int (*a)[kWin], int p, int q) {
    const int main = a[p][1 + (q >> 1)];
    const int far = a[p][(q & 1) ? 2 + (q >> 1) : (q >> 1)];
    return (3 * main + far + 8) >> 4;
}

template <bool kVec>
__device__ __forceinline__ uint64_t luma8(const uint8_t* __restrict__ p) {
    if (kVec) return *reinterpret_cast<const uint64_t*>(p);
    uint64_t w = 0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) w |= static_cast<uint64_t>(p[i]) << (8 * i);
    return w;
}

// The run's RGB bytes of one row (n of kRun pixels inside the crop) to
// `out`: 8-byte stores where the row's address allows, else bytes.
__device__ __forceinline__ void store_row(uint8_t* out, const uint32_t* w, int n) {
    if (n == kRun && (reinterpret_cast<uintptr_t>(out) & 7) == 0) {
#pragma unroll
        for (int i = 0; i < 3 * kRun / 8; ++i)
            reinterpret_cast<uint2*>(out)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
    } else {
#pragma unroll
        for (int i = 0; i < 3 * kRun; ++i)
            if (i < 3 * n) out[i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
    }
}

template <bool kVec>
__global__ void __launch_bounds__(kRunsX * kPairsY) yuv2rgb_kernel(
    const uint8_t* __restrict__ y, long long y_bs, const uint8_t* __restrict__ u, long long u_bs,
    const uint8_t* __restrict__ v, long long v_bs, int mbw, int width, int height,
    uint8_t* __restrict__ rgb) {
    const int run = blockIdx.x * kRunsX + threadIdx.x;
    const int k = blockIdx.y * kPairsY + threadIdx.y;
    const int b = blockIdx.z;
    const int j0 = run * kRun, c0 = run * kHalf;
    const int ch = (height + 1) >> 1, cw = (width + 1) >> 1;
    if (j0 >= width || k >= ch) return;
    const int cstride = mbw * 8, ystride = mbw * 16;
    const int n = min(kRun, width - j0);
    const bool two = 2 * k + 1 < height;

    int au[2][kWin], av[2][kWin];
    taps<kVec>(u + b * u_bs, cstride, k, ch, c0, cw, au);
    taps<kVec>(v + b * v_bs, cstride, k, ch, c0, cw, av);
    const uint8_t* yrow = y + b * y_bs + 2 * k * ystride + j0;
    const uint64_t yw[2] = {luma8<kVec>(yrow), two ? luma8<kVec>(yrow + ystride) : 0};

#pragma unroll
    for (int p = 0; p < 2; ++p) {
        if (p == 1 && !two) break;
        uint32_t w[3 * kRun / 4] = {};
#pragma unroll
        for (int q = 0; q < kRun; ++q) {
            const int uu = upsampled(au, p, q), vv = upsampled(av, p, q);
            const int yv = mulhi(static_cast<int>((yw[p] >> (8 * q)) & 0xff), 19077);
            const int r = clip255((yv + mulhi(vv, 26149) - 14234) >> 6);
            const int g = clip255((yv - mulhi(uu, 6419) - mulhi(vv, 13320) + 8708) >> 6);
            const int bl = clip255((yv + mulhi(uu, 33050) - 17685) >> 6);
            const int o = 3 * q;
            w[o >> 2] |= static_cast<uint32_t>(r) << (8 * (o & 3));
            w[(o + 1) >> 2] |= static_cast<uint32_t>(g) << (8 * ((o + 1) & 3));
            w[(o + 2) >> 2] |= static_cast<uint32_t>(bl) << (8 * ((o + 2) & 3));
        }
        uint8_t* out = rgb + static_cast<long long>(b * height + 2 * k + p) * (width * 3) + j0 * 3;
        store_row(out, w, n);
    }
}

bool aligned(const void* p, long long stride, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0 && stride % bytes == 0;
}

}  // namespace

WEBP_API int webp_yuv2rgb(const void* y, long long y_bs, const void* u, long long u_bs,
                          const void* v, long long v_bs, int mbw, int mbh, int width, int height,
                          int batch, void* rgb, void* stream) {
    if (width <= 0 || height <= 0 || batch <= 0) return 0;
    if (width > mbw * 16 || height > mbh * 16) return static_cast<int>(cudaErrorInvalidValue);
    const int runs = (width + kRun - 1) / kRun, pairs = (height + 1) / 2;
    const dim3 grid((runs + kRunsX - 1) / kRunsX, (pairs + kPairsY - 1) / kPairsY, batch);
    const dim3 block(kRunsX, kPairsY);
    auto s = static_cast<cudaStream_t>(stream);
    auto yp = static_cast<const uint8_t*>(y), up = static_cast<const uint8_t*>(u),
         vp = static_cast<const uint8_t*>(v);
    // 8-byte luma and 4-byte chroma loads where the planes allow them.
    if (aligned(y, y_bs, 8) && aligned(u, u_bs, 4) && aligned(v, v_bs, 4))
        yuv2rgb_kernel<true><<<grid, block, 0, s>>>(yp, y_bs, up, u_bs, vp, v_bs, mbw, width,
                                                     height, static_cast<uint8_t*>(rgb));
    else
        yuv2rgb_kernel<false><<<grid, block, 0, s>>>(yp, y_bs, up, u_bs, vp, v_bs, mbw, width,
                                                      height, static_cast<uint8_t*>(rgb));
    return static_cast<int>(cudaGetLastError());
}
