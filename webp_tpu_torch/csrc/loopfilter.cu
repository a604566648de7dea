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

#include "filter_mb.cuh"

namespace {

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
