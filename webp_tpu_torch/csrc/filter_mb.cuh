// filter_w: the VP8 loop filter of one line of 8 pixels, held in registers
// (RFC 6386 15.2-15.3).  The row pipeline's filter_tile (rows_mb.cuh) runs
// it on each line of an MB's tiles: K3, K17 and the fused recon_filter.
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

enum EdgeKind { kMbEdge, kSubEdge };

// Filter one line of 8 pixels w = p3 p2 p1 p0 | q0 q1 q2 q3 (RFC 6386
// 15.2-15.3, webp_tpu/ops/loopfilter.py) in place; false when the line
// fails the threshold and stays as it was.  Branch-free: every variant's
// values are formed and the edge's kind, the simple flag and hev select
// among them, so the lanes of a warp do not diverge on hev.
__device__ __forceinline__ bool filter_w(int* w, EdgeKind kind, bool simple, int hev_t,
                                         int interior, int limit) {
    const bool mask = simple ? simple_threshold(w, limit) : should_filter(w, interior, limit);
    const bool hev = !simple && high_edge_variance(w, hev_t);
    const int p2 = w[1] - 128, p1 = w[2] - 128, p0 = w[3] - 128;
    const int q0 = w[4] - 128, q1 = w[5] - 128, q2 = w[6] - 128;
    const int outer = c8(p1 - q1), d = 3 * (q0 - p0);
    // The 4-tap adjust of p0/q0 (step a4 to q0, b3 to p0): with the outer
    // taps except on an inner edge of the normal filter without high edge
    // variance.
    const bool use_outer = simple || kind == kMbEdge || hev;
    const int a = c8((use_outer ? outer : 0) + d);
    const int a4 = c8(a + 4) >> 3, b3 = c8(a + 3) >> 3;
    // Without high edge variance the normal filter widens: on an MB edge
    // (then a == c8(outer + d)) to p2..q2, on an inner edge to p1 and q1.
    const bool wide = !simple && !hev && kind == kMbEdge;
    const bool inner = !simple && !hev && kind == kSubEdge;
    const int a0 = c8((27 * a + 63) >> 7);
    const int a1 = c8((18 * a + 63) >> 7);
    const int a2 = c8((9 * a + 63) >> 7);
    const int s1 = (a4 + 1) >> 1;
    const int n1 = wide ? u8(p2 + a2) : w[1];
    const int n2 = wide ? u8(p1 + a1) : inner ? u8(p1 + s1) : w[2];
    const int n3 = wide ? u8(p0 + a0) : u8(p0 + b3);
    const int n4 = wide ? u8(q0 - a0) : u8(q0 - a4);
    const int n5 = wide ? u8(q1 - a1) : inner ? u8(q1 - s1) : w[5];
    const int n6 = wide ? u8(q2 - a2) : w[6];
    if (mask) {
        w[1] = n1; w[2] = n2; w[3] = n3; w[4] = n4; w[5] = n5; w[6] = n6;
    }
    return mask;
}

}  // namespace
