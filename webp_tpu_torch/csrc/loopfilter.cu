// Kernel K3: the VP8 loop filter, in place, in wavefront order.
//
// Replaces webp_tpu/ops/loopfilter2.py:192 filter_step, driven over the MB
// grid by loop_filter_frames_v2 (:280) and decode_frames_fused_v2.  The
// JAX version carries 3-slot rings of filtered rows and emits each MB two
// steps late, so that no op needs a dynamic index on a TPU; here the
// planes are filtered where they lie.
//
// Bound: latency of the dependency chain.  Filtering MB (x, y) reads
// pixels that (x-1, y), (x, y-1) and (x+1, y-1) have filtered, so the
// anti-diagonals t = x + 2y run in order, and inside an MB the edges run in
// order (left MB edge, inner vertical edges, top MB edge, inner horizontal
// edges: later edges read what earlier ones wrote).  Design: one block per
// image, one warp per MB row; in each edge step lanes 0-15 filter the 16
// luma lines and, in the normal filter, lanes 16-23 / 24-31 the 8 U / V
// lines, each lane one line of 8 pixels across the edge.

#include "common.cuh"

namespace {

__device__ __forceinline__ int c8(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
__device__ __forceinline__ int u8(int v) { return c8(v) + 128; }  // signed -> pixel

__device__ __forceinline__ bool simple_threshold(const int* w, int limit) {
    return abs(w[3] - w[4]) * 2 + abs(w[2] - w[5]) / 2 <= limit;
}

__device__ __forceinline__ bool should_filter(const int* w, int interior, int limit) {
    return simple_threshold(w, limit)
        && abs(w[0] - w[1]) <= interior && abs(w[1] - w[2]) <= interior
        && abs(w[2] - w[3]) <= interior && abs(w[7] - w[6]) <= interior
        && abs(w[6] - w[5]) <= interior && abs(w[5] - w[4]) <= interior;
}

__device__ __forceinline__ bool high_edge_variance(const int* w, int threshold) {
    return abs(w[2] - w[3]) > threshold || abs(w[5] - w[4]) > threshold;
}

// The 4-tap adjust of p0/q0; returns the rounded step a applied to q0.
__device__ __forceinline__ int common_adjust(int* w, bool use_outer) {
    const int p1 = w[2] - 128, p0 = w[3] - 128, q0 = w[4] - 128, q1 = w[5] - 128;
    const int a = c8((use_outer ? c8(p1 - q1) : 0) + 3 * (q0 - p0));
    const int b = c8(a + 3) >> 3;
    const int a4 = c8(a + 4) >> 3;
    w[4] = u8(q0 - a4);
    w[3] = u8(p0 + b);
    return a4;
}

enum EdgeKind { kMbEdge, kSubEdge };

// Filter one line of 8 pixels p3 p2 p1 p0 | q0 q1 q2 q3 (RFC 6386 15.2-15.3,
// webp_tpu/ops/loopfilter.py), `step` apart in memory, in place.
__device__ void filter_line(uint8_t* q0p, int step, EdgeKind kind, bool simple,
                            int hev_t, int interior, int limit) {
    int w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = q0p[(k - 4) * step];
    if (simple) {
        if (!simple_threshold(w, limit)) return;
        common_adjust(w, true);
    } else {
        if (!should_filter(w, interior, limit)) return;
        const bool hev = high_edge_variance(w, hev_t);
        if (kind == kMbEdge) {
            if (hev) {
                common_adjust(w, true);
            } else {
                const int p2 = w[1] - 128, p1 = w[2] - 128, p0 = w[3] - 128;
                const int q0 = w[4] - 128, q1 = w[5] - 128, q2 = w[6] - 128;
                const int wv = c8(c8(p1 - q1) + 3 * (q0 - p0));
                const int a0 = c8((27 * wv + 63) >> 7);
                const int a1 = c8((18 * wv + 63) >> 7);
                const int a2 = c8((9 * wv + 63) >> 7);
                w[4] = u8(q0 - a0);
                w[3] = u8(p0 + a0);
                w[5] = u8(q1 - a1);
                w[2] = u8(p1 + a1);
                w[6] = u8(q2 - a2);
                w[1] = u8(p2 + a2);
            }
        } else {
            const int p1 = w[2] - 128, q1 = w[5] - 128;
            const int a = common_adjust(w, hev);
            if (!hev) {
                const int a1 = (a + 1) >> 1;
                w[5] = u8(q1 - a1);
                w[2] = u8(p1 + a1);
            }
        }
    }
#pragma unroll
    for (int k = 1; k < 7; ++k) q0p[(k - 4) * step] = static_cast<uint8_t>(w[k]);
}

// The 8 edge steps of one MB: 0 left MB edge, 1-3 inner vertical edges,
// 4 top MB edge, 5-7 inner horizontal edges.  A chroma plane (n = 8) has
// one inner edge each way, at steps 1 and 5.
__device__ void filter_mb_lane(int lane, int x, int y, int mbw, bool simple,
                               int level, int interior, int hev_t, bool do_sub,
                               uint8_t* Y, uint8_t* U, uint8_t* V) {
    const int mb_lim = (level + 2) * 2 + interior;
    const int sub_lim = level * 2 + interior;
    int n, stride, line;
    uint8_t* p;
    if (lane < 16) {
        n = 16; stride = mbw * 16; line = lane; p = Y;
    } else {
        n = 8; stride = mbw * 8; line = lane & 7; p = lane < 24 ? U : V;
    }
    const bool active = lane < 16 || !simple;  // the simple filter leaves chroma alone
    const int row0 = y * n, col0 = x * n;
    for (int s = 0; s < 8; ++s) {
        const bool vertical = s < 4;
        const int k = s & 3;  // 0: MB edge, else inner edge at offset 4k
        bool on = active && (k == 0 ? (vertical ? x > 0 : y > 0) : do_sub && 4 * k < n);
        if (on) {
            uint8_t* q0p = vertical ? p + (row0 + line) * stride + col0 + 4 * k
                                    : p + (row0 + 4 * k) * stride + col0 + line;
            filter_line(q0p, vertical ? 1 : stride, k == 0 ? kMbEdge : kSubEdge, simple,
                        hev_t, interior, k == 0 ? mb_lim : sub_lim);
        }
        __syncwarp();
    }
}

__global__ void loopfilter_kernel(uint8_t* y, long long y_bs, uint8_t* u, long long u_bs,
                                  uint8_t* v, long long v_bs,
                                  const uint8_t* __restrict__ level, long long lv_bs,
                                  const uint8_t* __restrict__ interior, long long it_bs,
                                  const uint8_t* __restrict__ hev, long long hv_bs,
                                  const uint8_t* __restrict__ do_sub, long long ds_bs,
                                  int mbw, int mbh, int simple) {
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    uint8_t* Y = y + b * y_bs;
    uint8_t* U = u + b * u_bs;
    uint8_t* V = v + b * v_bs;
    const int T = wavefront_steps(mbw, mbh);
    for (int t = 0; t < T; ++t) {
        for (int r = warp; r < mbh; r += nwarps) {
            const int x = t - 2 * r;
            if (x < 0 || x >= mbw) continue;
            const int m = r * mbw + x;
            const int lvl = level[b * lv_bs + m];
            if (lvl == 0) continue;  // level 0 disables the whole MB
            filter_mb_lane(lane, x, r, mbw, simple != 0, lvl, interior[b * it_bs + m],
                           hev[b * hv_bs + m], do_sub[b * ds_bs + m] != 0, Y, U, V);
        }
        __syncthreads();
    }
}

}  // namespace

WEBP_API int webp_loopfilter(void* y, long long y_bs, void* u, long long u_bs,
                             void* v, long long v_bs,
                             const void* level, long long lv_bs, const void* interior, long long it_bs,
                             const void* hev, long long hv_bs, const void* do_sub, long long ds_bs,
                             int mbw, int mbh, int batch, int simple, void* stream) {
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    loopfilter_kernel<<<batch, wavefront_threads(mbh), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(y), y_bs, static_cast<uint8_t*>(u), u_bs,
        static_cast<uint8_t*>(v), v_bs,
        static_cast<const uint8_t*>(level), lv_bs, static_cast<const uint8_t*>(interior), it_bs,
        static_cast<const uint8_t*>(hev), hv_bs, static_cast<const uint8_t*>(do_sub), ds_bs,
        mbw, mbh, simple);
    return static_cast<int>(cudaGetLastError());
}
