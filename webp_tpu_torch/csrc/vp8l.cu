// Kernels K9-K12: the VP8L (lossless) inverse transforms, batched.
//
// Replace webp_tpu/ops/vp8l_device.py: K9 subtract_green (:45), K10
// color_transform (:51), K11 color_indexing (:74), K12
// inverse_predictor_batch (:159, jit body :173).  Pixels are uint8
// [B, h, w, 4] in R, G, B, A byte order, each read and written as one
// little-endian 32-bit word (R in the low byte).
//
// K9-K11 are bound by memory: a few integer ops per 4-byte pixel.  K9 and
// K10: one thread per pixel, consecutive threads on consecutive pixels, the
// grid's y index the image, in place.  K11 writes a new, wider image: a CTA
// per run of rows of an image (at least 16 KB of output) loads the image's
// palette (1 KB) into shared memory once, beside its first packed loads, and
// a thread expands groups of 4 (or 8) pixels into 16-byte stores
// (color_indexing_kernel below).
//
// K12 is a 2D recurrence: pixel (x, y) needs the final values of its left,
// top-left, top and top-right neighbours, so an image is one chain of
// w + 2(h - 1) dependent pixel steps (the knight move: pixel (x, y) at step
// x + 2y); its bytes take microseconds.  The bound is the latency of one
// step times the chain, plus the hand-overs below.  Design
// (predictor_rows_kernel): a warp owns a band of 32 rows, one lane a row;
// at the warp's step s lane r finishes pixel x = s - 2r.  Its left
// neighbour is the lane's own last output, and lane r - 1 finished the
// top-right, top and top-left at steps s - 1, s - 2 and s - 3: three
// __shfl_up_sync of a three-output register history.  So a step touches
// no global memory and meets no barrier.  The residuals go through a
// per-band shared tile, a ring of 128 columns a row padded to 129 words so
// that the diagonal a step reads hits 32 banks: chunk c of 32 steps is row
// i's columns 32c - 2i + lane, copied in by cp.async two chunks ahead and
// stored back a chunk behind, eight rows right after each sub-chunk's wait
// (coalesced rows); the modes go through the band's predictor-image rows,
// a ring of block columns.  The steps run eight at a time (a sub-chunk):
// fully unrolled chunks (10K instructions) thrash the instruction cache
// once four bands run different parts of them.
//
// A CTA stacks kWarps bands (128 rows) and two helper warps.  A band's top
// lane takes the row above from a shared ring of 256 columns (edge[k]):
// band k - 1's bottom lane writes it and publishes the count of columns
// written (made[k]) after every sub-chunk; band k starts the sub-chunk at
// step sq once made >= sq + kSub (kLag + 1) - kSpan, which the band above
// reaches kLag = 8 sub-chunks ahead (the top lane's last top-right of the
// sub-chunk is kSub columns on, and the bottom lane trails the top by
// kSpan = 62 steps), reads the sub-chunk's columns into registers, and
// frees columns (used[k]) a chunk at a time; a writer never runs more than
// the ring ahead of its reader.  A lone lane's wait leaves the warp
// diverged, and a diverged warp takes every later shuffle through the slow
// path, so the warp reconverges (__syncwarp) after it.  Between CTAs the
// outbound warp copies the CTA's bottom row from edge[kWarps] to a global
// edge row and publishes its count with fence + st.release.gpu; the
// inbound warp of the CTA below polls it with ld.acquire.gpu, copies the
// columns through L2 (__ldcg) into edge[0], and publishes them to band 0.
// Neither the fence nor the poll lies on a band's chain.  CTAs take (image,
// 128-row band) tickets in order of height, so a CTA only waits on bands
// whose CTAs already run: no cooperative launch, any number of CTAs.
//
// A step's prediction is branch-free: the 14 predictors in SWAR (byte-wise
// averages, __vsadu4 for Select, SIMD on 16-bit fields for the two clamped
// modes), the edge rules as modes 0-2, and a four-level select tree on the
// mode's bits, so a warp whose lanes span 32 rows x 64 columns of mode
// blocks takes one path.  PERF.md (section 5) has the versions tried.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

// K11: a CTA per (image, run of `rows` rows) of 256 threads; the image's
// palette loaded once a CTA, one word a thread, beside the thread's first
// packed loads and before the CTA's one barrier.  An item is a group of G
// output pixels of a row (8 at 8 indices a byte, else 4) on the output's
// 16-byte lattice: a row whose first word lies m words past an aligned
// address starts its lattice at x = -m, so every group that lies wholly in
// its row is one (or two) 16-byte stores, and the groups that hold the row's
// head or tail store 4 bytes a pixel.  An aligned group reads its packed
// words in one load (16 B unpacked, 8 B at 2 indices a byte, 4 B at 4 or
// 8); one whose packed words are not aligned reads them 4 bytes at a time.
// Items run over the CTA's rows in the order (row, group), tid + 256 k for
// the thread's k-th item, stepped without a division.
constexpr int kIndexBatch = 8;  // items a thread loads before it gathers any

template <int kWbits>
struct IndexItem {
    static constexpr int G = kWbits == 3 ? 8 : 4;           // output pixels of a group
    static constexpr int Q = kWbits == 3 ? 1 : 4 >> kWbits; // packed words of an aligned group
    static constexpr int kBits = 8 >> kWbits;               // bits of an index
};

// Palette index of pixel j of a row in its packed word w (j mod the
// indices a byte picks its bits).
template <int kWbits>
__device__ __forceinline__ int packed_index(uint32_t w, int j) {
    constexpr int kBits = IndexItem<kWbits>::kBits;
    return (channel(w, 1) >> ((j & ((1 << kWbits) - 1)) * kBits)) & ((1 << kBits) - 1);
}

template <int kWbits>
__device__ __forceinline__ void color_indexing_rows(
    const uint32_t* __restrict__ px, int pw, const uint32_t* __restrict__ table, int width,
    int h, int rows, uint32_t* __restrict__ out) {
    using I = IndexItem<kWbits>;
    constexpr int G = I::G, Q = I::Q;
    __shared__ uint32_t palette[256];
    const int b = blockIdx.y, tid = threadIdx.x, r0 = blockIdx.x * rows;
    const uint32_t pal = table[b * 256 + tid];  // kThreads == 256
    // The lattice: words from an aligned address to each row's first word.
    const unsigned base = static_cast<unsigned>(reinterpret_cast<uintptr_t>(out) >> 2) & 3;
    const bool even = width % 4 == 0 && base == 0;  // every row starts aligned
    const int ng = even ? (width + G - 1) / G : (width + 3 + G - 1) / G;  // groups a row
    const int items = min(rows, h - r0) * ng;
    const int step_rows = kThreads / ng, step_g = kThreads % ng;
    int row = tid / ng, g = tid % ng;  // the thread's item, stepped by kThreads

    for (int first = 0; first < items; first += kThreads * kIndexBatch) {
        uint32_t q[kIndexBatch][Q];
        int x0[kIndexBatch], rr[kIndexBatch];
        bool vec_load[kIndexBatch];
#pragma unroll
        for (int k = 0; k < kIndexBatch; ++k) {  // every load of the batch before any gather
            const bool live = first + k * kThreads + tid < items;
            const long long img_row = static_cast<long long>(b) * h + r0 + row;
            const int m = static_cast<int>(
                (static_cast<unsigned>(img_row) * static_cast<unsigned>(width) + base) & 3);
            x0[k] = g * G - m;
            rr[k] = row;
            const uint32_t* p = px + img_row * pw + (x0[k] >> kWbits);
            vec_load[k] = live && m == 0 && x0[k] + G <= width &&
                          (reinterpret_cast<uintptr_t>(p) & (4 * Q - 1)) == 0;
            if (!live) x0[k] = width;  // an empty item
            if (vec_load[k]) {
                if constexpr (Q == 4) {
                    const uint4 v = *reinterpret_cast<const uint4*>(p);
                    q[k][0] = v.x; q[k][1] = v.y; q[k][2] = v.z; q[k][3] = v.w;
                } else if constexpr (Q == 2) {
                    const uint2 v = *reinterpret_cast<const uint2*>(p);
                    q[k][0] = v.x; q[k][1] = v.y;
                } else {
                    q[k][0] = *p;
                }
            }
            g += step_g;
            row += step_rows;
            if (g >= ng) { g -= ng; ++row; }
        }
        if (first == 0) {
            palette[tid] = pal;
            __syncthreads();
        }
#pragma unroll
        for (int k = 0; k < kIndexBatch; ++k) {
            const int x = x0[k];
            if (x >= width) continue;
            const long long img_row = static_cast<long long>(b) * h + r0 + rr[k];
            uint32_t* o = out + img_row * width + x;
            uint32_t v[G];
            if (vec_load[k]) {
#pragma unroll
                for (int j = 0; j < G; ++j) v[j] = palette[packed_index<kWbits>(q[k][j * Q / G], j)];
            } else {
                const uint32_t* prow = px + img_row * pw;
#pragma unroll
                for (int j = 0; j < G; ++j) {
                    const int xj = x + j;
                    v[j] = xj >= 0 && xj < width
                               ? palette[packed_index<kWbits>(prow[xj >> kWbits], xj)]
                               : 0;
                }
            }
            if (x >= 0 && x + G <= width) {  // on the lattice: 16-byte stores
#pragma unroll
                for (int j = 0; j < G; j += 4) {
                    *reinterpret_cast<uint4*>(o + j) = make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
                }
            } else {  // the row's head or tail
#pragma unroll
                for (int j = 0; j < G; ++j) {
                    if (x + j >= 0 && x + j < width) o[j] = v[j];
                }
            }
        }
    }
}

// The instances: 2 indices a byte (palettes of 5-16 colours) held to 3 CTAs
// an SM (80 registers; 7% less time at batch 8 and 64 than as the compiler
// allots, PERF.md section 6), the others as the compiler allots (a bound
// made them spill or slower).
template <int kWbits>
__global__ void __launch_bounds__(kThreads) color_indexing_kernel(
    const uint32_t* __restrict__ px, int pw, const uint32_t* __restrict__ table, int width,
    int h, int rows, uint32_t* __restrict__ out) {
    color_indexing_rows<kWbits>(px, pw, table, width, h, rows, out);
}

__global__ void __launch_bounds__(kThreads, 3) color_indexing_kernel_2(
    const uint32_t* __restrict__ px, int pw, const uint32_t* __restrict__ table, int width,
    int h, int rows, uint32_t* __restrict__ out) {
    color_indexing_rows<1>(px, pw, table, width, h, rows, out);
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBand = 32;                 // rows of a warp's band, one a lane
constexpr int kWarps = 4;                 // bands of a CTA
constexpr int kPredThreads = 32 * (kWarps + 2);  // + the inbound and outbound warps
constexpr int kChunk = 32;                // steps of a tile chunk: 32 columns of each row
constexpr int kSub = 8;                   // steps between hand-overs of a band's bottom row
constexpr int kSpan = 2 * (kBand - 1);    // steps from a band's top lane to its bottom lane
constexpr int kLag = 8;                   // sub-chunks a band trails the band above
constexpr int kRing = 128;                // columns of a band's tile ring
constexpr int kStride = kRing + 1;        // words of a tile row
constexpr int kEdgeRing = 256;            // columns of a shared edge ring
constexpr int kModeRows = 8;              // predictor-image rows a band spans (size_bits >= 2)
constexpr int kModeRing = 64;             // block columns of a band's mode-row ring

struct PredShared {
    uint32_t tile[kWarps][kBand * kStride];  // residuals, then outputs, in place
    uint8_t mode[kWarps][kModeRows * kModeRing];  // the band's predictor-image rows (14: zero)
    uint32_t edge[kWarps + 1][kEdgeRing];    // the row above band k; [kWarps] the CTA's bottom row
    int made[kWarps + 1];                    // columns written to edge[k]
    int used[kWarps + 1];                    // columns of edge[k] its reader no longer needs
    int ticket;
};

struct PredArgs {
    uint32_t* px;
    const uint8_t* modes;
    int size_bits, w, h, batch, bands;  // bands: CTAs of an image
    uint32_t* gedge;                    // [batch, bands, w]: each CTA's bottom row
    int* prog;                          // [batch * bands] columns of gedge published, then the ticket
};

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_shared_volatile(const int* p) {
    return *static_cast<const volatile int*>(p);
}

// Publish a shared counter after this thread's shared stores (and, after a
// __syncwarp, its warp's).
__device__ __forceinline__ void publish_shared(int* p, int v) {
    __threadfence_block();
    *static_cast<volatile int*>(p) = v;
}

// Byte-wise floor((a + b) / 2).
__device__ __forceinline__ uint32_t avg_bytes(uint32_t a, uint32_t b) {
    return (a & b) + (((a ^ b) & 0xfefefefeu) >> 1);
}

// Two bytes of a pixel word as the 16-bit fields of one word: the even
// channels (R, B) or the odd ones (G, A).
constexpr uint32_t kEven = 0x00ff00ffu;

// clip255 of each signed 16-bit field.
__device__ __forceinline__ uint32_t clip_halves(uint32_t v) {
    return __vmins2(__vmaxs2(v, 0u), kEven);
}

// Each signed 16-bit field / 2, toward zero.
__device__ __forceinline__ uint32_t half_toward_zero(uint32_t d) {
    d = __vadd2(d, (d >> 15) & 0x00010001u);
    return ((d >> 1) & 0x7fff7fffu) | (d & 0x80008000u);
}

// The prediction of `mode` (0-13; 14 predicts zero) from the final
// neighbours, as RGBA words.  Branch-free: every predictor in SWAR (the
// averages byte-wise, Select by __vsadu4, the clamped modes on 16-bit
// fields by the SIMD intrinsics), then a select tree on the mode's bits.
__device__ __forceinline__ uint32_t predict_select(int mode, uint32_t L, uint32_t T, uint32_t TL,
                                                   uint32_t TR) {
    const uint32_t p5 = avg_bytes(avg_bytes(L, TR), T);
    const uint32_t p6 = avg_bytes(L, TL);
    const uint32_t p7 = avg_bytes(L, T);
    const uint32_t p8 = avg_bytes(TL, T);
    const uint32_t p9 = avg_bytes(T, TR);
    const uint32_t p10 = avg_bytes(p6, p9);
    // Select: L when sum |T - TL| < sum |L - TL|.
    const uint32_t p11 = __vsadu4(T, TL) < __vsadu4(L, TL) ? L : T;
    // ClampAddSubtractFull, clip255(L + T - TL), and ClampAddSubtractHalf,
    // clip255(a + (a - TL) / 2) with a = avg(L, T), per channel: the even and
    // the odd bytes as signed 16-bit fields.
    const uint32_t p12 =
        clip_halves(__vsub2(__vadd2(L & kEven, T & kEven), TL & kEven)) |
        clip_halves(__vsub2(__vadd2((L >> 8) & kEven, (T >> 8) & kEven), (TL >> 8) & kEven)) << 8;
    const uint32_t a_lo = p7 & kEven, a_hi = (p7 >> 8) & kEven;
    const uint32_t p13 =
        clip_halves(__vadd2(a_lo, half_toward_zero(__vsub2(a_lo, TL & kEven)))) |
        clip_halves(__vadd2(a_hi, half_toward_zero(__vsub2(a_hi, (TL >> 8) & kEven)))) << 8;
    const bool b0 = mode & 1, b1 = mode & 2, b2 = mode & 4, b3 = mode & 8;
    const uint32_t s01 = b0 ? L : 0xff000000u, s23 = b0 ? TR : T, s45 = b0 ? p5 : TL,
                   s67 = b0 ? p7 : p6, s89 = b0 ? p9 : p8, s1011 = b0 ? p11 : p10,
                   s1213 = b0 ? p13 : p12;
    const uint32_t s03 = b1 ? s23 : s01, s47 = b1 ? s67 : s45, s811 = b1 ? s1011 : s89,
                   s1215 = b1 ? 0u : s1213;
    const uint32_t s07 = b2 ? s47 : s03, s815 = b2 ? s1215 : s811;
    return b3 ? s815 : s07;
}

// Compute warp k of a CTA: the band of rows y0 .. y0 + 31 (see the head of
// the file for the schedule and the hand-overs).
__device__ __forceinline__ void predictor_band(const PredArgs& a, PredShared& S, int b, int j,
                                               int k, int lane) {
    const int w = a.w, h = a.h, sb = a.size_bits;
    const int y0 = (j * kWarps + k) * kBand;
    if (y0 >= h) return;
    const int rows = min(kBand, h - y0);
    const int y = y0 + lane;
    const bool live = lane < rows;
    const bool above = y0 > 0;
    // Whether a reader takes this band's bottom row: the next band of the
    // CTA, or the outbound warp for the CTA below.  Then rows == kBand.
    const bool feeds = k + 1 < kWarps ? y0 + kBand < h : j + 1 < a.bands;
    const int bw = (w + (1 << sb) - 1) >> sb;
    const int bh = (h + (1 << sb) - 1) >> sb;
    uint32_t* img = a.px + static_cast<long long>(b) * w * h;
    const uint8_t* mimg = a.modes + static_cast<long long>(b) * bw * bh;
    uint32_t* tile = S.tile[k];
    uint8_t* mrow = S.mode[k];
    const uint32_t* ein = S.edge[k];
    uint32_t* eout = S.edge[k + 1];
    const int n_chunks = (w + 2 * (rows - 1) + kChunk - 1) / kChunk;

    // Row i's pixels of chunk c, one column a lane: kChunk * c - 2i + lane
    // (what lane i runs in chunk c).  The tile ring holds chunk c while it
    // runs, chunk c + 1 and chunk c + 2, whose rows are copied straight from
    // the image by cp.async kSub rows at a time during chunk c (one group a
    // chunk, awaited two chunks later); the finished chunk c - 1 goes back to
    // the image the same way.  The modes: the band's predictor-image rows in
    // a ring of block columns, each chunk's new columns (pixels kChunk * c ..
    // + kChunk - 1) loaded into registers three chunks ahead and stored two
    // chunks ahead, so that no load is waited on where it is issued.
    auto col = [&](int c, int i) { return kChunk * c - 2 * i + lane; };
    auto inside = [&](int x, int i) { return i < rows && x >= 0 && x < w; };
    auto fetch_rows = [&](int c, int r0) {
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
            const int r = r0 + t, x = col(c, r);
            if (inside(x, r)) cp_async4(&tile[r * kStride + (x & (kRing - 1))], &img[(y0 + r) * w + x]);
        }
    };
    const int my0 = y0 >> sb;
    const int n_mrows = ((y0 + rows - 1) >> sb) - my0 + 1;
    const int mcols = max(1, kChunk >> sb);  // block columns of a chunk's new pixels
    // Element e = lane + 32 p (p = 0, 1) of chunk c's new block columns:
    // (predictor row m, block column bx), valid when both lie in the image.
    auto mode_at = [&](int c, int p, int& slot) -> int {
        const int e = lane + 32 * p, m = e / mcols;
        const int bx = ((kChunk * c) >> sb) + e % mcols;
        slot = m * kModeRing + (bx & (kModeRing - 1));
        return m < n_mrows && bx < bw ? (my0 + m) * bw + bx : -1;
    };
    uint32_t pm[2];
    auto load_modes = [&](int c) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            int slot;
            const int at = mode_at(c, p, slot);
            pm[p] = at >= 0 ? __ldg(mimg + at) : 0u;
        }
    };
    auto store_modes = [&](int c) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            int slot;
            if (mode_at(c, p, slot) >= 0) mrow[slot] = min(pm[p], 14u);
        }
    };
    for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int r0 = 0; r0 < kBand; r0 += kSub) fetch_rows(c, r0);
        cp_async_commit();
        load_modes(c);
        store_modes(c);
    }
    load_modes(2);
    const int lane_mrow = ((y >> sb) - my0) * kModeRing;

    uint32_t h1 = 0, h2 = 0, h3 = 0;  // the lane's outputs of the last three steps
    uint32_t first = 0;               // the lane's pixel 0: the last column's top-right
    uint32_t te = 0, tle = 0;         // lane 0: the row above at columns s and s - 1
    uint32_t ev[kSub] = {};           // lane 0: the row above at columns s + 1 .. s + kSub
    for (int c = 0; c < n_chunks; ++c) {
        // Chunk c's copies are done (chunk c + 1's may still fly); the modes of
        // chunk c + 2's new columns into the ring, chunk c + 3's loaded.
        cp_async_wait<1>();
        store_modes(c + 2);
        load_modes(c + 3);
        __syncwarp();
        const int s0 = kChunk * c;
        // The columns of the row above that lane 0 no longer reads (it holds
        // column s0 in a register from chunk 1 on); room in the ring below
        // for this chunk's bottom row.
        if (above && lane == 0 && c > 0) publish_shared(&S.used[k], min(w, s0 + 1));
        if (feeds && lane == kBand - 1) {
            const int hi = min(w, s0 + kChunk - kSpan);
            while (hi > ld_shared_volatile(&S.used[k + 1]) + kEdgeRing) __nanosleep(20);
        }
#pragma unroll 1
        for (int q = 0; q < kChunk / kSub; ++q) {
            const int sq = s0 + kSub * q;
            if (above && lane == 0) {
                // The row above over the sub-chunk's steps, once the band
                // above is kLag sub-chunks ahead.
                const int need = min(w, sq + kSub * (kLag + 1) - kSpan);
                while (ld_shared_volatile(&S.made[k]) < need) __nanosleep(20);
                __threadfence_block();
                if (sq == 0) te = ein[0];
#pragma unroll
                for (int t = 0; t < kSub; ++t) ev[t] = ein[(sq + 1 + t) & (kEdgeRing - 1)];
            }
            // Reconverge after the one lane's wait: a warp left diverged takes
            // every later shuffle through the slow divergent path.
            __syncwarp();
            // Rows kSub * q .. + kSub - 1: chunk c - 1 back to the image, chunk
            // c + 2 copied in.  Issued right after the wait, their global
            // accesses are done by the fences at the sub-chunk's end.  The
            // shared loads read masked slots; only the stores are predicated.
            uint32_t back[kSub];
#pragma unroll
            for (int t = 0; t < kSub; ++t) {
                const int r = kSub * q + t;
                back[t] = tile[r * kStride + (col(c - 1, r) & (kRing - 1))];
            }
#pragma unroll
            for (int t = 0; t < kSub; ++t) {
                const int r = kSub * q + t, xb = col(c - 1, r);
                if (c > 0 && inside(xb, r)) img[(y0 + r) * w + xb] = back[t];
            }
            fetch_rows(c + 2, kSub * q);
            // The lane's residuals and modes of the sub-chunk, before its stores.
            uint32_t res[kSub];
            int mode[kSub];
#pragma unroll
            for (int t = 0; t < kSub; ++t) {
                const int x = sq + t - 2 * lane;
                res[t] = tile[lane * kStride + (x & (kRing - 1))];
                mode[t] = mrow[lane_mrow + ((x >> sb) & (kModeRing - 1))];
            }
#pragma unroll
            for (int t = 0; t < kSub; ++t) {
                // The step: lane r finishes pixel x = s - 2r.
                const int s = sq + t;
                const int x = s - 2 * lane;
                const uint32_t tr_e = ev[t];
                const uint32_t up_tr = __shfl_up_sync(kFull, h1, 1);
                const uint32_t up_t = __shfl_up_sync(kFull, h2, 1);
                const uint32_t up_tl = __shfl_up_sync(kFull, h3, 1);
                const uint32_t T = lane ? up_t : te, TL = lane ? up_tl : tle;
                const uint32_t TR = x + 1 < w ? (lane ? up_tr : tr_e) : first;
                tle = te;
                te = tr_e;
                // The edges as modes: (0, 0) black (0), row 0 L (1), column 0 T (2).
                const int m = y == 0 ? (x == 0 ? 0 : 1) : (x == 0 ? 2 : mode[t]);
                const uint32_t out = add_bytes(res[t], predict_select(m, h1, T, TL, TR));
                const bool on = live && x >= 0 && x < w;
                if (on) tile[lane * kStride + (x & (kRing - 1))] = out;
                if (feeds && lane == kBand - 1 && on) eout[x & (kEdgeRing - 1)] = out;
                if (t == kSub - 1 && feeds && lane == kBand - 1)
                    publish_shared(&S.made[k + 1], max(0, min(w, s + 1 - kSpan)));
                if (t == kSub - 1) __syncwarp();
                first = x == 0 ? out : first;
                h3 = h2;
                h2 = h1;
                h1 = out;
            }
        }
        cp_async_commit();
    }
    // The last chunk back to the image.
    cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kBand; ++i) {
        const int xb = col(n_chunks - 1, i);
        if (inside(xb, i)) img[(y0 + i) * w + xb] = tile[i * kStride + (xb & (kRing - 1))];
    }
}

// The inbound warp: the row above the CTA, from the band above's global
// edge row into edge[0], as far as it is published.
__device__ __forceinline__ void predictor_inbound(const PredArgs& a, PredShared& S, int b, int j,
                                                  int lane) {
    if (j == 0) return;
    const int w = a.w;
    const long long band = static_cast<long long>(b) * a.bands + j - 1;
    const uint32_t* gin = a.gedge + band * w;
    const int* pin = a.prog + band;
    for (int done = 0; done < w;) {
        int avail = 0;
        if (lane == 0) {
            // Published, and at most a ring ahead of what band 0 still reads.
            while ((avail = min(ld_acquire(pin), ld_shared_volatile(&S.used[0]) + kEdgeRing))
                   <= done)
                __nanosleep(64);
        }
        __syncwarp();
        avail = __shfl_sync(kFull, avail, 0);
        for (int x = done + lane; x < avail; x += 32)
            S.edge[0][x & (kEdgeRing - 1)] = __ldcg(gin + x);
        __syncwarp();
        if (lane == 0) publish_shared(&S.made[0], avail);
        done = avail;
    }
}

// The outbound warp: the CTA's bottom row from edge[kWarps] to its global
// edge row, published for the CTA below as far as it is written.
__device__ __forceinline__ void predictor_outbound(const PredArgs& a, PredShared& S, int b, int j,
                                                   int lane) {
    if (j + 1 >= a.bands) return;
    const int w = a.w;
    const long long band = static_cast<long long>(b) * a.bands + j;
    uint32_t* gout = a.gedge + band * w;
    int* pout = a.prog + band;
    for (int done = 0; done < w;) {
        int avail = 0;
        if (lane == 0) {
            while ((avail = ld_shared_volatile(&S.made[kWarps])) <= done) __nanosleep(64);
            __threadfence_block();
        }
        __syncwarp();
        avail = __shfl_sync(kFull, avail, 0);
        for (int x = done + lane; x < avail; x += 32) gout[x] = S.edge[kWarps][x & (kEdgeRing - 1)];
        __syncwarp();
        if (lane == 0) {
            publish_shared(&S.used[kWarps], avail);
            __threadfence();
            st_release(pout, avail);
        }
        done = avail;
    }
}

__global__ void __launch_bounds__(kPredThreads) predictor_rows_kernel(PredArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    PredShared& S = *reinterpret_cast<PredShared*>(smem);
    if (threadIdx.x == 0) S.ticket = atomicAdd(a.prog + a.batch * a.bands, 1);
    if (threadIdx.x <= kWarps) {
        S.made[threadIdx.x] = 0;
        S.used[threadIdx.x] = 0;
    }
    __syncthreads();
    const int j = S.ticket / a.batch, b = S.ticket % a.batch;  // bands in order of height
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < kWarps) predictor_band(a, S, b, j, warp, lane);
    else if (warp == kWarps) predictor_inbound(a, S, b, j, lane);
    else predictor_outbound(a, S, b, j, lane);
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

// Rows of a K11 CTA: the fewest (a power of two, at most h) whose output
// is at least 16 KB.
static int index_rows(int width, int h) {
    int rows = 1;
    while (rows < h && static_cast<long long>(rows) * width < 4096) rows <<= 1;
    return rows < h ? rows : h;
}

WEBP_API int webp_vp8l_color_indexing(const void* px, int pw, const void* table, int table_size,
                                      int width, int h, int batch, void* out, void* stream) {
    if (width <= 0 || h <= 0 || batch <= 0) return 0;
    const int wbits = table_size <= 2 ? 3 : table_size <= 4 ? 2 : table_size <= 16 ? 1 : 0;
    if (pw != (width + (1 << wbits) - 1) >> wbits) return static_cast<int>(cudaErrorInvalidValue);
    const int rows = index_rows(width, h);
    const dim3 grid((h + rows - 1) / rows, batch);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* p = static_cast<const uint32_t*>(px);
    const auto* t = static_cast<const uint32_t*>(table);
    auto* o = static_cast<uint32_t*>(out);
    switch (wbits) {
        case 0: color_indexing_kernel<0><<<grid, kThreads, 0, s>>>(p, pw, t, width, h, rows, o); break;
        case 1: color_indexing_kernel_2<<<grid, kThreads, 0, s>>>(p, pw, t, width, h, rows, o); break;
        case 2: color_indexing_kernel<2><<<grid, kThreads, 0, s>>>(p, pw, t, width, h, rows, o); break;
        default: color_indexing_kernel<3><<<grid, kThreads, 0, s>>>(p, pw, t, width, h, rows, o);
    }
    return static_cast<int>(cudaGetLastError());
}

// CTAs of K12 for an image of h rows.
WEBP_API int webp_vp8l_predictor_bands(int h) { return (h + kWarps * kBand - 1) / (kWarps * kBand); }

// gedge: [batch, bands, w] int32 scratch; prog: [batch * bands + 1] int32, zeroed.
WEBP_API int webp_vp8l_predictor(void* px, const void* modes, int size_bits, int w, int h,
                                 int batch, void* gedge, void* prog, void* stream) {
    if (w <= 0 || h <= 0 || batch <= 0) return 0;
    if (size_bits < 2 || size_bits > 9) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>(sizeof(PredShared));
    const cudaError_t err = cudaFuncSetAttribute(
        predictor_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    PredArgs a;
    a.px = static_cast<uint32_t*>(px);
    a.modes = static_cast<const uint8_t*>(modes);
    a.size_bits = size_bits;
    a.w = w;
    a.h = h;
    a.batch = batch;
    a.bands = webp_vp8l_predictor_bands(h);
    a.gedge = static_cast<uint32_t*>(gedge);
    a.prog = static_cast<int*>(prog);
    predictor_rows_kernel<<<batch * a.bands, kPredThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// K12 CTAs the card keeps resident at once (the occupancy API over all SMs
// of the current device); -1 on an error.
WEBP_API int webp_vp8l_predictor_resident() {
    int dev = 0, sms = 0, per_sm = 0;
    const int smem = static_cast<int>(sizeof(PredShared));
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || cudaFuncSetAttribute(predictor_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, predictor_rows_kernel,
                                                         kPredThreads, smem) != cudaSuccess)
        return -1;
    return per_sm * sms;
}
