// filter_mb_lane: the VP8 loop filter of one MB, by one warp, in place in
// the planes.  Shared by K3 (loopfilter.cu) and K17 (banded.cu).
#pragma once

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

}  // namespace
