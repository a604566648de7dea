// Kernels K9-K12: the VP8L (lossless) inverse transforms, batched.
//
// Replace webp_tpu/ops/vp8l_device.py: K9 subtract_green (:45), K10
// color_transform (:51), K11 color_indexing (:74), K12
// inverse_predictor_batch (:159, jit body :173).  Pixels are uint8
// [B, h, w, 4] in R, G, B, A byte order, each read and written as one
// little-endian 32-bit word (R in the low byte).
//
// K9-K11 are bound by memory: a few integer ops per 4-byte pixel.  One
// thread per pixel, consecutive threads on consecutive pixels, the grid's
// y index the image.  K9 and K10 work in place; K11 keeps its image's
// palette (1 KB) in shared memory and writes a new, wider image.
//
// K12 is a 2D recurrence: pixel (x, y) needs the final values of its left,
// top-left, top and top-right neighbours.  As in the JAX version it runs a
// "knight move" wavefront over 4-pixel groups: step t finishes group
// gx = t - 2y of every row y at once, whose neighbours were finished at
// steps t-1 (left, top-right), t-2 (top) and t-3 (top-left); the last
// column's top-right is the row's own first pixel, finished at step 2y.
// A group never straddles a predictor block (size_bits >= 2), so it has one
// mode.  One block per image works in place in global memory: a pixel
// reads only its own residual and neighbours already final, and a step's
// groups never read one another.  The threads stride over the rows active
// at the step (about ceil(w/4)/2 of them) and meet at one __syncthreads()
// per step, ceil(w/4) + 2(h-1) steps.  The bound is the chain of steps,
// not bytes: a batch of B fills B of the card's 132 SMs.  A thread issues
// all of its group's loads before it computes, and stores the four pixels
// at the end (PERF.md: what a step costs, and what did not cut it).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // pixels of a predictor wavefront group

// Bytewise (mod 256) sum of two RGBA words.
__device__ __forceinline__ uint32_t add_bytes(uint32_t a, uint32_t b) {
    return (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu) |
           (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u);
}

__device__ __forceinline__ int channel(uint32_t p, int c) { return (p >> (8 * c)) & 0xff; }

__device__ __forceinline__ int s8(int v) { return static_cast<int8_t>(static_cast<uint8_t>(v)); }

__global__ void __launch_bounds__(kThreads) subtract_green_kernel(uint32_t* __restrict__ px,
                                                                  long long n) {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= n) return;
    const uint32_t p = px[i];
    const uint32_t g = (p >> 8) & 0xff;
    px[i] = add_bytes(p, g | (g << 16));
}

__global__ void __launch_bounds__(kThreads) color_transform_kernel(
    uint32_t* __restrict__ px, const uint32_t* __restrict__ tf, int size_bits, int w, int h) {
    const int b = blockIdx.y;
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= static_cast<long long>(w) * h) return;
    const int y = static_cast<int>(i / w), x = static_cast<int>(i % w);
    const int bw = (w + (1 << size_bits) - 1) >> size_bits;
    const int bh = (h + (1 << size_bits) - 1) >> size_bits;
    const uint32_t coef =
        tf[(static_cast<long long>(b) * bh + (y >> size_bits)) * bw + (x >> size_bits)];
    const int red_to_blue = s8(channel(coef, 0));
    const int green_to_blue = s8(channel(coef, 1));
    const int green_to_red = s8(channel(coef, 2));
    uint32_t* p = px + static_cast<long long>(b) * w * h + i;
    const uint32_t v = *p;
    const int green = s8(channel(v, 1));
    const int red = (channel(v, 0) + ((green_to_red * green) >> 5)) & 0xff;
    const int blue =
        (channel(v, 2) + ((green_to_blue * green) >> 5) + ((red_to_blue * s8(red)) >> 5)) & 0xff;
    *p = (v & 0xff00ff00u) | static_cast<uint32_t>(red) | (static_cast<uint32_t>(blue) << 16);
}

__global__ void __launch_bounds__(kThreads) color_indexing_kernel(
    const uint32_t* __restrict__ px, int pw, const uint32_t* __restrict__ table, int wbits,
    int width, int h, uint32_t* __restrict__ out) {
    __shared__ uint32_t palette[256];
    const int b = blockIdx.y;
    palette[threadIdx.x] = table[b * 256 + threadIdx.x];  // kThreads == 256
    __syncthreads();
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= static_cast<long long>(width) * h) return;
    const int y = static_cast<int>(i / width), x = static_cast<int>(i % width);
    const int packed =
        channel(px[(static_cast<long long>(b) * h + y) * pw + (x >> wbits)], 1);
    const int bits = 8 >> wbits;
    const int idx = (packed >> ((x & ((1 << wbits) - 1)) * bits)) & ((1 << bits) - 1);
    out[static_cast<long long>(b) * width * h + i] = palette[idx];
}

__device__ __forceinline__ int avg2(int a, int b) { return (a + b) >> 1; }

__device__ __forceinline__ int clamp_half(int a, int b) {
    const int d = a - b;
    return clip255(a + (d >= 0 ? d >> 1 : -((-d) >> 1)));  // (a - b) / 2 toward zero
}

// The prediction of mode `mode` from the final neighbours (RGBA words).
// Modes 14 and 15 (and any larger) predict zero, as the JAX device path does.
__device__ uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TL, uint32_t TR) {
    switch (mode) {
    case 0: return 0xff000000u;
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 11: {
        int pl = 0, pt = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int p = channel(L, c) + channel(T, c) - channel(TL, c);
            pl += abs(p - channel(L, c));
            pt += abs(p - channel(T, c));
        }
        return pl < pt ? L : T;
    }
    default: break;
    }
    if (mode > 13) return 0;
    uint32_t out = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int l = channel(L, c), t = channel(T, c), tl = channel(TL, c), tr = channel(TR, c);
        int v;
        switch (mode) {
        case 5: v = avg2(avg2(l, tr), t); break;
        case 6: v = avg2(l, tl); break;
        case 7: v = avg2(l, t); break;
        case 8: v = avg2(tl, t); break;
        case 9: v = avg2(t, tr); break;
        case 10: v = avg2(avg2(l, tl), avg2(t, tr)); break;
        case 12: v = clip255(l + t - tl); break;
        default: v = clamp_half(avg2(l, t), tl); break;  // 13
        }
        out |= static_cast<uint32_t>(v) << (8 * c);
    }
    return out;
}

__global__ void __launch_bounds__(kThreads) predictor_kernel(
    uint32_t* __restrict__ px, const uint8_t* __restrict__ modes, int size_bits, int w, int h) {
    const int b = blockIdx.x;
    const int bw = (w + (1 << size_bits) - 1) >> size_bits;
    const int bh = (h + (1 << size_bits) - 1) >> size_bits;
    const int gw = (w + kGroup - 1) / kGroup;
    uint32_t* img = px + static_cast<long long>(b) * w * h;
    const uint8_t* mimg = modes + static_cast<long long>(b) * bw * bh;
    const int steps = gw + 2 * (h - 1);
    for (int t = 0; t < steps; ++t) {
        // Rows whose group gx = t - 2y lies in [0, gw).
        const int y0 = max(0, (t - gw + 2) >> 1), y1 = min(h - 1, t >> 1);
        for (int y = y0 + static_cast<int>(threadIdx.x); y <= y1; y += kThreads) {
            const int x0 = (t - 2 * y) * kGroup;
            const int n = min(kGroup, w - x0);
            uint32_t* row = img + static_cast<long long>(y) * w;
            const uint32_t* above = row - w;  // read only when y > 0
            // Every load of the group first, so that their latencies overlap:
            // residuals, left, the row above from x0-1 to x0+4, the row's
            // first pixel (final unless this is group 0) and the mode.
            uint32_t res[kGroup], top[kGroup + 2], out[kGroup];
#pragma unroll
            for (int j = 0; j < kGroup; ++j) res[j] = j < n ? row[x0 + j] : 0;
#pragma unroll
            for (int j = 0; j < kGroup + 2; ++j) {
                const int x = x0 - 1 + j;
                top[j] = y > 0 && x >= 0 && x < w ? above[x] : 0;
            }
            uint32_t left = x0 > 0 ? row[x0 - 1] : 0;
            const uint32_t first = x0 > 0 ? row[0] : 0;
            const int mode = mimg[(y >> size_bits) * bw + (x0 >> size_bits)];
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
                const int x = x0 + j;
                uint32_t pred;
                if (y == 0) {
                    pred = x == 0 ? 0xff000000u : left;  // opaque black, then L
                } else if (x == 0) {
                    pred = top[1];                        // T
                } else {
                    // The last column's top-right is the row's first pixel.
                    const uint32_t tr = x + 1 < w ? top[j + 2] : (x0 > 0 ? first : out[0]);
                    pred = predict(mode, left, top[j + 1], top[j], tr);
                }
                left = add_bytes(res[j], pred);
                out[j] = left;
            }
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
                if (j < n) row[x0 + j] = out[j];
        }
        __syncthreads();
    }
}

inline unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

WEBP_API int webp_vp8l_subtract_green(void* px, long long n_pixels, void* stream) {
    if (n_pixels <= 0) return 0;
    subtract_green_kernel<<<blocks_for(n_pixels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(px), n_pixels);
    return static_cast<int>(cudaGetLastError());
}

WEBP_API int webp_vp8l_color_transform(void* px, const void* tf, int size_bits, int w, int h,
                                       int batch, void* stream) {
    if (w <= 0 || h <= 0 || batch <= 0) return 0;
    const dim3 grid(blocks_for(static_cast<long long>(w) * h), batch);
    color_transform_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(px), static_cast<const uint32_t*>(tf), size_bits, w, h);
    return static_cast<int>(cudaGetLastError());
}

WEBP_API int webp_vp8l_color_indexing(const void* px, int pw, const void* table, int table_size,
                                      int width, int h, int batch, void* out, void* stream) {
    if (width <= 0 || h <= 0 || batch <= 0) return 0;
    const int wbits = table_size <= 2 ? 3 : table_size <= 4 ? 2 : table_size <= 16 ? 1 : 0;
    if (pw != (width + (1 << wbits) - 1) >> wbits) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(blocks_for(static_cast<long long>(width) * h), batch);
    color_indexing_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(px), pw, static_cast<const uint32_t*>(table), wbits, width,
        h, static_cast<uint32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}

WEBP_API int webp_vp8l_predictor(void* px, const void* modes, int size_bits, int w, int h,
                                 int batch, void* stream) {
    if (w <= 0 || h <= 0 || batch <= 0) return 0;
    if (size_bits < 2 || size_bits > 9) return static_cast<int>(cudaErrorInvalidValue);
    predictor_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(px), static_cast<const uint8_t*>(modes), size_bits, w, h);
    return static_cast<int>(cudaGetLastError());
}
