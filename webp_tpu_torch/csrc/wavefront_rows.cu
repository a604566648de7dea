// Kernels K2 recon, K3 loopfilter and their fusion recon_filter: the
// decode's intra prediction + residue and its VP8 loop filter over the MB
// grid, as one kernel template rows_kernel<kRecon, kFilter>.
//
// Replaces (webp_tpu/ops/):
//   webp_recon         <1,0>  K2  wavefront2.py:152 recon_step (driven by
//                                 reconstruct_frames_v2 :337)
//   webp_loopfilter    <0,1>  K3  loopfilter2.py:192 filter_step (driven by
//                                 loop_filter_frames_v2 :281)
//   webp_recon_filter  <1,1>  K2+K3, the decode's main path:
//                                 wavefront2.py:274 decode_frames_fused_v2
// The JAX steps route rows through ring buffers and predict the ten B
// modes as one matmul, both TPU workarounds; here each predictor is
// computed directly (RFC 6386 12.3, common.cuh predict_b4) and each edge is
// filtered line by line (filter_mb.cuh filter_line).
//
// Bound: latency of the dependency chain.  An MB needs its left, top-left,
// top and top-right neighbours, so an image's MBs form a chain of about
// T = mbw + 2(mbh - 1) MB latencies (110 at 768x512), each ended by a
// hand-over between rows; the bytes (the planes once, the per-MB inputs
// once) take microseconds.  Design: one CTA of four warps per (image, MB
// row) over the whole card and no barrier across an image.  A CTA takes
// its row from a ticket (an atomic counter the wrapper zeroes), rows in
// order of height, so it only ever waits on rows whose CTAs already run:
// no cooperative launch, no deadlock when the CTAs outnumber the resident
// slots.  A row runs in iterations: iteration i reconstructs MB i (K2) or
// filters it (K3); the fused kernel filters MB i - 1 on one warp while the
// other three reconstruct MB i, so it has mbw + 1 iterations.  Iteration i
// of row r starts when row r-1's progress counter reaches min(i + 2,
// iterations); thread 0 polls it with ld.acquire.gpu, other CTAs' pixels
// are read through L2 (__ldcg), and after the iteration's writes thread 0
// publishes i + 1 with a fence and st.release.gpu.  The working MBs and
// the left neighbour's columns stay in shared memory.
//
// Dependencies of the fused kernel (a pixel "of" an MB lies in its 16x16):
// - Recon of (x, y) reads UNFILTERED pixels: the bottom row of (x-1..x+1,
//   y-1) (top-left corner, top, top-right; at x = mbw-1 the top-right
//   repeats column x0+15; at y = 0 the row above reads 127 and at x = 0
//   the left column 129), and the right column of (x-1, y).
// - Filtering (x, y) writes columns 16x-3..16x+15 of its 16 rows (the left
//   MB edge reaches 3 pixels into (x-1, y)) and rows 16y-3..16y-1 of
//   columns 16x..16x+15 (the top MB edge reaches into (x, y-1)).  Its
//   vertical edges change its bottom row, which recon of (x, y+1) and of
//   (x-1, y+1) (top-right) still needs unfiltered; its horizontal edges
//   change its right column, which recon of (x+1, y) still needs
//   unfiltered.  So each MB's unfiltered edges are saved before it is
//   filtered, as libwebp keeps its unfiltered top samples: the bottom row
//   in the per-row edge buffer in device memory (read by the row below
//   through L2), the right column in shared memory.
// - The filter of (x, y) needs (x-1, y), (x, y-1) and (x+1, y-1) fully
//   filtered ((x+1, y-1)'s left edge reaches columns 16x+13..16x+15 of
//   (x, y-1)); (x+2, y-1) does not touch (x, y-1).  Row y-1 has done both
//   by its iteration x + 1 (x + 2 in the fused kernel, which filters MB x
//   in iteration x + 1), and recon of (x, y) needs row y-1's recon up to
//   MB x + 1, done by its iteration x + 1: so the one wait, for row y-1's
//   iteration i + 1, serves the recon and the filter of iteration i, and
//   row y-1 touches none of the pixels that iteration reads or writes
//   after publishing i + 2.  In the fused kernel the recon of MB i and the
//   filter of MB i - 1 touch disjoint pixels, so they run side by side.
// - In the simple filter chroma is never filtered: recon's chroma is the
//   output.  A level-0 MB is not filtered.
//
// Inside a CTA an iteration has three phases between barriers.  Loads: the
// edges from the row above (the edge buffer) for the recon; the 4 filtered
// rows above the filtered MB (and for K3 alone the MB itself) into its
// filter tiles.  Compute: the recon puts I16 and chroma pixels across its
// threads (all four warps in K2, warps 0-2 in the fused kernel) and runs
// a B-predicted MB's 16 subblocks as their own 10-step wavefront (t = sbx
// + 2 sby, one subblock a half-warp of warp 0) while the other recon warps
// do chroma; the recon threads also fetch the next MB's residues and B
// modes into registers, off the chain.  The filter runs on one warp (warp
// 3 fused, warp 0 in K3) on a 20x20 (chroma 12x12) tile with 4 margin rows
// above and columns left, double-buffered between MBs, one line a lane (16
// luma, 8 U, 8 V) held in registers, in the order of filter_mb.cuh (left MB
// edge, inner vertical edges, top MB edge, inner horizontal edges), each
// edge through the branch-free filter_w.  Stores: the MB's unfiltered
// bottom row to the edge buffer, the tiles back to the planes.
//
// Memory model: pixels another CTA wrote are read with __ldcg after the
// acquire; the planes are never read through a const __restrict__ pointer,
// which the compiler may turn into ld.global.nc.

#include "filter_mb.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileY = 20;  // luma filter tile: 4 margin + 16
constexpr int kTileC = 12;  // chroma: 4 + 8

struct Shared {
    int rs[2][24 * 16];  // residues of MB i in slot i & 1, fetched during MB i - 1
    // Recon workspaces, unfiltered: row 0 the corner, the pixels above and
    // (luma) 4 above-right; column 0 the left MB's right column; the MB at
    // [1..][1..].
    uint8_t wy[17][21];
    uint8_t wc[2][9][9];
    // Filter tiles of MB i in slot i & 1: rows 0-3 the 4 filtered rows above
    // the MB, columns 0-3 the left MB's last 4 filtered columns, the MB at
    // [4..][4..].
    uint8_t fy[2][kTileY][kTileY];
    uint8_t fc[2][2][kTileC][kTileC];
    uint8_t bp[2][16];  // B modes, slots as rs
    int row;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// DC of an n x n block from its workspace (stride s, corner at w[0]): the
// rounded mean of the neighbours that exist, 128 at the frame's top-left MB.
__device__ int ws_dc(const uint8_t* w, int s, int n, int log2n, bool above, bool left) {
    if (!above && !left) return 128;
    int total = 0;
    for (int i = 0; i < n; ++i) {
        if (above) total += w[1 + i];
        if (left) total += w[(1 + i) * s];
    }
    const int shf = log2n - 1 + above + left;
    return (total + (1 << (shf - 1))) >> shf;
}

// Whole-block DC/V/H/TM prediction of pixel (r, c) from the workspace.
__device__ __forceinline__ int ws_pred(int mode, const uint8_t* w, int s, int r, int c, int dc) {
    switch (mode) {
    case 0: return dc;
    case 1: return w[1 + c];
    case 2: return w[(1 + r) * s];
    default: return clip255(w[(1 + r) * s] + w[1 + c] - w[0]);
    }
}

// One pixel of a B-predicted subblock (lanes of a half-warp, k = pixel):
// its 13 edge pixels from the workspace, the mode's prediction, the residue.
__device__ __forceinline__ int b4_pixel(const uint8_t (*wy)[21], int sbx, int sby, int mode,
                                        int k, int residue) {
    const int py = 1 + sby * 4, px = 1 + sbx * 4;  // workspace coordinates
    int e[13];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[3 - i] = wy[py + i][px - 1];
    e[4] = wy[py - 1][px - 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[5 + i] = wy[py - 1][px + i];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[9 + i] = sbx < 3 ? wy[py - 1][px + 4 + i] : wy[0][17 + i];
    int out[16];
    predict_b4(mode, e, out);
    int pred = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) pred = i == k ? out[i] : pred;
    return clip255(pred + residue);
}

// One MB's filter on the tiles, by one warp: each lane holds one line of
// 16 luma (lanes 0-15), 8 U (16-23) or 8 V (24-31) pixels with its 4
// margin pixels in registers; first its row through the vertical edges
// (the left MB edge, then the inner ones), then, once the warp's rows are
// back in the tile, its column through the horizontal edges (the top MB
// edge, then the inner ones): the order of filter_mb_lane, whose 8 edge
// steps touch each line only through the line's own pixels.
__device__ __forceinline__ void filter_tile(int lane, bool left_edge, bool top_edge, bool simple,
                                            int level, int interior, int hev_t, bool do_sub,
                                            uint8_t* fy, uint8_t* fu, uint8_t* fv) {
    const int mb_lim = (level + 2) * 2 + interior;
    const int sub_lim = level * 2 + interior;
    int n, stride, line;
    uint8_t* p;
    if (lane < 16) {
        n = 16; stride = kTileY; line = lane; p = fy;
    } else {
        n = 8; stride = kTileC; line = lane & 7; p = lane < 24 ? fu : fv;
    }
    const bool active = lane < 16 || !simple;  // the simple filter leaves chroma alone
    int px[kTileY];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
        const bool vertical = pass == 0;
        uint8_t* base = vertical ? p + (4 + line) * stride : p + 4 + line;
        const int step = vertical ? 1 : stride;
        if (active) {
#pragma unroll
            for (int i = 0; i < kTileY; ++i)
                if (i < n + 4) px[i] = base[i * step];
#pragma unroll
            for (int k = 0; k < 4; ++k) {  // 0: MB edge, else the inner edge at offset 4k
                const bool on = k == 0 ? (vertical ? left_edge : top_edge) : do_sub && 4 * k < n;
                if (on)
                    filter_w(px + 4 * k, k == 0 ? kMbEdge : kSubEdge, simple, hev_t, interior,
                             k == 0 ? mb_lim : sub_lim);
            }
#pragma unroll
            for (int i = 1; i < kTileY; ++i)
                if (i < n + 4) base[i * step] = static_cast<uint8_t>(px[i]);
        }
        __syncwarp();
    }
}

struct Args {
    const int32_t* res;
    const uint8_t *lmode, *bpred, *cmode, *level, *interior, *hev, *do_sub;
    long long lm_bs, bp_bs, cm_bs, lv_bs, it_bs, hv_bs, ds_bs;
    int mbw, mbh, batch, simple;
    uint8_t *y, *u, *v;
    long long y_bs, u_bs, v_bs;
    uint8_t* edge;  // [batch, mbh, 2W]: each row's unfiltered bottom pixels (luma W, U, V W/2)
    int* prog;      // [batch * mbh] finished MBs of each row, then the row ticket
};

// Row r of image b (from the ticket) walks its MBs left to right.  Iteration
// i reconstructs MB i (K2, fused) and filters MB f = i - kLag (K3, fused):
// the fused kernel filters MB i - 1 on warp 3 while warps 0-2 reconstruct
// MB i, so it runs mbw + 1 iterations.  After iteration i the row's counter
// is i + 1, and iteration i waits for the row above's counter to reach
// min(i + 2, iterations): recon of MB i needs the row above's unfiltered
// edge up to MB i + 1, and the filter of MB f needs the row above filtered
// up to MB f and MB f + 1's left edge, both done by its iteration i + 1.
template <bool kRecon, bool kFilter>
__global__ void __launch_bounds__(kThreads) rows_kernel(const Args a) {
    constexpr int kLag = kRecon && kFilter ? 1 : 0;
    constexpr int kReconThreads = kFilter ? kThreads - 32 : kThreads;
    constexpr int kFilterWarp = kRecon ? 3 : 0;
    constexpr int kPre = (24 * 16 + kReconThreads - 1) / kReconThreads;  // residues a thread fetches
    __shared__ Shared S;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    if (tid == 0) S.row = atomicAdd(a.prog + static_cast<long long>(a.batch) * a.mbh, 1);
    if (kRecon && tid < 16) {  // the left column of the row's first MB
        S.wy[1 + tid][0] = 129;
        S.wc[tid >> 3][1 + (tid & 7)][0] = 129;
    }
    __syncthreads();
    const int b = S.row % a.batch, r = S.row / a.batch;
    const int mbw = a.mbw, nmb = mbw * a.mbh;
    const int W = mbw * 16, CW = mbw * 8;
    const bool simple = a.simple != 0;
    const bool cfilt = kFilter && !simple;  // chroma goes through the filter tiles
    uint8_t* Y = a.y + b * a.y_bs;
    uint8_t* U = a.u + b * a.u_bs;
    uint8_t* V = a.v + b * a.v_bs;
    const long long erow = 2LL * W;
    const uint8_t* above = a.edge + (static_cast<long long>(b) * a.mbh + r - 1) * erow;  // r > 0
    uint8_t* mine = a.edge + (static_cast<long long>(b) * a.mbh + r) * erow;
    const int* done_above = a.prog + static_cast<long long>(b) * a.mbh + r - 1;
    const int y0 = r * 16, cy0 = r * 8;
    const int32_t* res_row =  // the row's residues and B modes (recon)
        kRecon ? a.res + (static_cast<long long>(b) * nmb + r * mbw) * 24 * 16 : nullptr;
    const uint8_t* bp_row = kRecon ? a.bpred + b * a.bp_bs + r * mbw * 16 : nullptr;
    if (kRecon) {  // MB 0's residues and B modes
        for (int k = tid; k < 24 * 16; k += kThreads) S.rs[0][k] = __ldg(res_row + k);
        if (tid < 16) S.bp[0][tid] = __ldg(bp_row + tid);
    }
    const int n_iter = mbw + kLag;

    for (int i = 0; i < n_iter; ++i) {
        if (tid == 0 && r > 0) {
            const int need = min(i + 2, n_iter);
            while (ld_acquire(done_above) < need) __nanosleep(32);
        }
        __syncthreads();
        const bool rec = kRecon && i < mbw;   // MB i's recon
        const int f = i - kLag;               // the MB this iteration filters
        const bool filt = kFilter && f >= 0;
        const int x0 = i * 16, cx0 = i * 8, m = r * mbw + i;
        const int fx0 = f * 16, fcx0 = f * 8, mf = r * mbw + f;
        uint8_t(*ty)[kTileY] = S.fy[f & 1];
        uint8_t(*tc)[kTileC][kTileC] = S.fc[f & 1];

        // 1. Loads: the unfiltered edges from the row above (recon of MB i);
        //    the 4 filtered rows above MB f and, for K3 alone, MB f (filter).
        if (rec) {
            if (tid < 21) {
                int val = 127;
                if (r > 0) {
                    if (tid == 0) val = i == 0 ? 129 : __ldcg(above + x0 - 1);
                    else if (tid <= 16) val = __ldcg(above + x0 + tid - 1);
                    else val = __ldcg(above + (i == mbw - 1 ? x0 + 15 : x0 + tid - 1));
                }
                S.wy[0][tid] = static_cast<uint8_t>(val);
            } else if (tid >= 32 && tid < 50) {
                const int p = (tid - 32) / 9, k = (tid - 32) % 9;
                int val = 127;
                if (r > 0) {
                    const uint8_t* ac = above + W + p * (W / 2);
                    val = k == 0 ? (i == 0 ? 129 : __ldcg(ac + cx0 - 1)) : __ldcg(ac + cx0 + k - 1);
                }
                S.wc[p][0][k] = static_cast<uint8_t>(val);
            }
        }
        if (filt) {
            if (r > 0) {
                if (tid < 64) {
                    const int j = tid >> 4, c = tid & 15;
                    ty[j][4 + c] = __ldcg(Y + (y0 - 4 + j) * W + fx0 + c);
                } else if (cfilt) {
                    const int k = tid - 64, p = k >> 5, j = (k >> 3) & 3, c = k & 7;
                    tc[p][j][4 + c] = __ldcg((p ? V : U) + (cy0 - 4 + j) * CW + fcx0 + c);
                }
            }
            if (!kRecon) {
                for (int k = tid; k < 256; k += kThreads)
                    ty[4 + (k >> 4)][4 + (k & 15)] = __ldcg(Y + (y0 + (k >> 4)) * W + fx0 + (k & 15));
                if (cfilt) {
                    const int p = tid >> 6, j = (tid >> 3) & 7, c = tid & 7;
                    tc[p][4 + j][4 + c] = __ldcg((p ? V : U) + (cy0 + j) * CW + fcx0 + c);
                }
            }
        }
        __syncthreads();

        // 2. Recon of MB i into the workspaces (and its filter tiles) on the
        //    first kReconThreads threads, which also fetch MB i + 1's residues
        //    and B modes; the filter of MB f on warp kFilterWarp.
        if (rec && tid < kReconThreads) {
            const int cur = i & 1;
            const bool more = i + 1 < mbw;
            int pre[kPre];
#pragma unroll
            for (int j = 0; j < kPre; ++j) {
                const int k = tid + j * kReconThreads;
                pre[j] = more && k < 24 * 16 ? __ldg(res_row + (i + 1) * 24 * 16 + k) : 0;
            }
            const int bp_next = more && tid < 16 ? __ldg(bp_row + (i + 1) * 16 + tid) : 0;
            const int lm = a.lmode[b * a.lm_bs + m], cm = a.cmode[b * a.cm_bs + m];
            const int* rs = S.rs[cur];
            const int dcu = cm == 0 ? ws_dc(&S.wc[0][0][0], 9, 8, 3, r > 0, i > 0) : 0;
            const int dcv = cm == 0 ? ws_dc(&S.wc[1][0][0], 9, 8, 3, r > 0, i > 0) : 0;
            int first_c = tid, step_c = kReconThreads;  // chroma pixels of this thread
            if (lm == 4) {
                if (warp == 0) {
                    const int half = lane >> 4, k = lane & 15;
                    for (int t = 0; t < 10; ++t) {
                        const int sbx = (t & 1) + 2 * half, sby = (t - sbx) >> 1;
                        if (t >= sbx && sby < 4) {
                            const int sb = sby * 4 + sbx;
                            const int val = b4_pixel(S.wy, sbx, sby, S.bp[cur][sb], k, rs[sb * 16 + k]);
                            const int pr = sby * 4 + (k >> 2), pc = sbx * 4 + (k & 3);
                            S.wy[1 + pr][1 + pc] = static_cast<uint8_t>(val);
                            if (kFilter) S.fy[cur][4 + pr][4 + pc] = static_cast<uint8_t>(val);
                        }
                        __syncwarp();
                    }
                    step_c = 0;
                } else {
                    first_c = tid - 32;
                    step_c = kReconThreads - 32;
                }
            } else {
                const int dc = lm == 0 ? ws_dc(&S.wy[0][0], 21, 16, 4, r > 0, i > 0) : 0;
                for (int p = tid; p < 256; p += kReconThreads) {
                    const int pr = p >> 4, pc = p & 15;
                    const int blk = (pr >> 2) * 4 + (pc >> 2), k = (pr & 3) * 4 + (pc & 3);
                    const int val = clip255(ws_pred(lm, &S.wy[0][0], 21, pr, pc, dc) + rs[blk * 16 + k]);
                    S.wy[1 + pr][1 + pc] = static_cast<uint8_t>(val);
                    if (kFilter) S.fy[cur][4 + pr][4 + pc] = static_cast<uint8_t>(val);
                }
            }
            for (int p = first_c; step_c && p < 128; p += step_c) {
                const int pl = p >> 6, pr = (p >> 3) & 7, pc = p & 7;
                const int blk = 16 + pl * 4 + (pr >> 2) * 2 + (pc >> 2), k = (pr & 3) * 4 + (pc & 3);
                const int val = clip255(ws_pred(cm, &S.wc[pl][0][0], 9, pr, pc, pl ? dcv : dcu)
                                        + rs[blk * 16 + k]);
                S.wc[pl][1 + pr][1 + pc] = static_cast<uint8_t>(val);
                if (cfilt) S.fc[cur][pl][4 + pr][4 + pc] = static_cast<uint8_t>(val);
            }
            if (more) {
#pragma unroll
                for (int j = 0; j < kPre; ++j) {
                    const int k = tid + j * kReconThreads;
                    if (k < 24 * 16) S.rs[cur ^ 1][k] = pre[j];
                }
                if (tid < 16) S.bp[cur ^ 1][tid] = static_cast<uint8_t>(bp_next);
            }
        }
        const int lvl = filt ? a.level[b * a.lv_bs + mf] : 0;
        if (filt && warp == kFilterWarp && lvl != 0)
            filter_tile(lane, f > 0, r > 0, simple, lvl, a.interior[b * a.it_bs + mf],
                        a.hev[b * a.hv_bs + mf], a.do_sub[b * a.ds_bs + mf] != 0, &ty[0][0],
                        &tc[0][0][0], &tc[1][0][0]);
        __syncthreads();

        // 3. Stores: MB i's unfiltered bottom row for the row below, its right
        //    column as MB i + 1's left, and the pixels no filter changes; the
        //    tiles of MB f back to the planes (the MB, the rows above and the
        //    left MB's columns the filter changed), its last 4 columns the
        //    left margin of MB f + 1's tiles.
        if (rec) {
            if (tid < 16) {
                mine[x0 + tid] = S.wy[16][1 + tid];
                S.wy[1 + tid][0] = S.wy[1 + tid][16];
            } else if (tid < 32) {
                const int p = (tid - 16) >> 3, c = tid & 7;
                mine[W + p * (W / 2) + cx0 + c] = S.wc[p][8][1 + c];
                S.wc[p][1 + c][0] = S.wc[p][1 + c][8];
            }
            if (!kFilter) {  // K2: the luma MB as it is
                for (int p = tid; p < 256; p += kThreads)
                    Y[(y0 + (p >> 4)) * W + x0 + (p & 15)] = S.wy[1 + (p >> 4)][1 + (p & 15)];
            }
            if (!kFilter || simple) {  // chroma that no filter changes
                const int pl = tid >> 6, pr = (tid >> 3) & 7, pc = tid & 7;
                (pl ? V : U)[(cy0 + pr) * CW + cx0 + pc] = S.wc[pl][1 + pr][1 + pc];
            }
        }
        if (filt) {
            const bool on = lvl != 0;
            uint8_t(*ny)[kTileY] = S.fy[(f + 1) & 1];
            uint8_t(*nc)[kTileC][kTileC] = S.fc[(f + 1) & 1];
            if (kRecon || on) {
                for (int p = tid; p < 256; p += kThreads)
                    Y[(y0 + (p >> 4)) * W + fx0 + (p & 15)] = ty[4 + (p >> 4)][4 + (p & 15)];
                if (cfilt) {
                    const int pl = tid >> 6, pr = (tid >> 3) & 7, pc = tid & 7;
                    (pl ? V : U)[(cy0 + pr) * CW + fcx0 + pc] = tc[pl][4 + pr][4 + pc];
                }
            }
            if (on && r > 0) {
                if (tid < 48) {
                    const int j = 1 + tid / 16, c = tid & 15;
                    Y[(y0 - 4 + j) * W + fx0 + c] = ty[j][4 + c];
                } else if (cfilt && tid >= 64 && tid < 112) {
                    const int k = tid - 64, p = k / 24, j = 1 + (k % 24) / 8, c = k & 7;
                    (p ? V : U)[(cy0 - 4 + j) * CW + fcx0 + c] = tc[p][j][4 + c];
                }
            }
            if (tid < 64) {
                const int j = tid >> 2, c = tid & 3;
                if (on && f > 0 && c > 0) Y[(y0 + j) * W + fx0 - 4 + c] = ty[4 + j][c];
                ny[4 + j][c] = ty[4 + j][16 + c];
            } else if (cfilt) {
                const int k = tid - 64, p = k >> 5, j = (k >> 2) & 7, c = k & 3;
                if (on && f > 0 && c > 0) (p ? V : U)[(cy0 + j) * CW + fcx0 - 4 + c] = tc[p][4 + j][c];
                nc[p][4 + j][c] = tc[p][4 + j][8 + c];
            }
        }
        __syncthreads();
        if (tid == 0) {
            __threadfence();
            st_release(a.prog + static_cast<long long>(b) * a.mbh + r, i + 1);
        }
    }
}

// One link of a chain of CTAs: CTA i (by ticket) waits until flag i-1 is set
// with the kernel's own acquire poll, then sets flag i with its release.
// Times the hand-over between rows that bounds the kernels above from below.
__global__ void handoff_chain_kernel(int n, int* flags) {
    __shared__ int ticket;
    if (threadIdx.x == 0) {
        ticket = atomicAdd(flags + n, 1);
        if (ticket > 0)
            while (ld_acquire(flags + ticket - 1) == 0) __nanosleep(32);
        __threadfence();
        st_release(flags + ticket, 1);
    }
}

int launch(bool recon, bool filter, const Args& a, void* stream) {
    if (a.mbw <= 0 || a.mbh <= 0 || a.batch <= 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(a.batch * a.mbh);
    if (recon && filter) rows_kernel<true, true><<<grid, kThreads, 0, s>>>(a);
    else if (recon) rows_kernel<true, false><<<grid, kThreads, 0, s>>>(a);
    else rows_kernel<false, true><<<grid, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

WEBP_API int webp_recon(const void* res, const void* lmode, long long lm_bs,
                        const void* bpred, long long bp_bs, const void* cmode, long long cm_bs,
                        int mbw, int mbh, int batch,
                        void* y, long long y_bs, void* u, long long u_bs, void* v, long long v_bs,
                        void* edge, void* prog, void* stream) {
    Args a = {};
    a.res = static_cast<const int32_t*>(res);
    a.lmode = static_cast<const uint8_t*>(lmode); a.lm_bs = lm_bs;
    a.bpred = static_cast<const uint8_t*>(bpred); a.bp_bs = bp_bs;
    a.cmode = static_cast<const uint8_t*>(cmode); a.cm_bs = cm_bs;
    a.mbw = mbw; a.mbh = mbh; a.batch = batch;
    a.y = static_cast<uint8_t*>(y); a.y_bs = y_bs;
    a.u = static_cast<uint8_t*>(u); a.u_bs = u_bs;
    a.v = static_cast<uint8_t*>(v); a.v_bs = v_bs;
    a.edge = static_cast<uint8_t*>(edge);
    a.prog = static_cast<int*>(prog);
    return launch(true, false, a, stream);
}

WEBP_API int webp_loopfilter(void* y, long long y_bs, void* u, long long u_bs,
                             void* v, long long v_bs,
                             const void* level, long long lv_bs, const void* interior, long long it_bs,
                             const void* hev, long long hv_bs, const void* do_sub, long long ds_bs,
                             int mbw, int mbh, int batch, int simple, void* prog, void* stream) {
    Args a = {};
    a.level = static_cast<const uint8_t*>(level); a.lv_bs = lv_bs;
    a.interior = static_cast<const uint8_t*>(interior); a.it_bs = it_bs;
    a.hev = static_cast<const uint8_t*>(hev); a.hv_bs = hv_bs;
    a.do_sub = static_cast<const uint8_t*>(do_sub); a.ds_bs = ds_bs;
    a.mbw = mbw; a.mbh = mbh; a.batch = batch; a.simple = simple;
    a.y = static_cast<uint8_t*>(y); a.y_bs = y_bs;
    a.u = static_cast<uint8_t*>(u); a.u_bs = u_bs;
    a.v = static_cast<uint8_t*>(v); a.v_bs = v_bs;
    a.prog = static_cast<int*>(prog);
    return launch(false, true, a, stream);
}

WEBP_API int webp_recon_filter(const void* res, const void* lmode, long long lm_bs,
                               const void* bpred, long long bp_bs, const void* cmode,
                               long long cm_bs, const void* level, long long lv_bs,
                               const void* interior, long long it_bs, const void* hev,
                               long long hv_bs, const void* do_sub, long long ds_bs,
                               int mbw, int mbh, int batch, int simple,
                               void* y, long long y_bs, void* u, long long u_bs, void* v,
                               long long v_bs, void* edge, void* prog, void* stream) {
    Args a = {};
    a.res = static_cast<const int32_t*>(res);
    a.lmode = static_cast<const uint8_t*>(lmode); a.lm_bs = lm_bs;
    a.bpred = static_cast<const uint8_t*>(bpred); a.bp_bs = bp_bs;
    a.cmode = static_cast<const uint8_t*>(cmode); a.cm_bs = cm_bs;
    a.level = static_cast<const uint8_t*>(level); a.lv_bs = lv_bs;
    a.interior = static_cast<const uint8_t*>(interior); a.it_bs = it_bs;
    a.hev = static_cast<const uint8_t*>(hev); a.hv_bs = hv_bs;
    a.do_sub = static_cast<const uint8_t*>(do_sub); a.ds_bs = ds_bs;
    a.mbw = mbw; a.mbh = mbh; a.batch = batch; a.simple = simple;
    a.y = static_cast<uint8_t*>(y); a.y_bs = y_bs;
    a.u = static_cast<uint8_t*>(u); a.u_bs = u_bs;
    a.v = static_cast<uint8_t*>(v); a.v_bs = v_bs;
    a.edge = static_cast<uint8_t*>(edge);
    a.prog = static_cast<int*>(prog);
    return launch(true, true, a, stream);
}

// Row CTAs of one instantiation the card keeps resident at once (the
// occupancy API over all SMs of the current device); -1 on an error.
WEBP_API int webp_recon_filter_resident(int recon, int filter) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return -1;
    const cudaError_t err =
        recon && filter ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_kernel<true, true>, kThreads, 0)
        : recon ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_kernel<true, false>, kThreads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_kernel<false, true>, kThreads, 0);
    return err == cudaSuccess ? per_sm * sms : -1;
}

// A chain of n CTAs handing a flag on (flags [n + 1] int32, zeroed; the last
// slot is the ticket): its time over n is one hand-over.
WEBP_API int webp_handoff_chain(int n, void* flags, void* stream) {
    if (n <= 0) return 0;
    handoff_chain_kernel<<<n, 32, 0, static_cast<cudaStream_t>(stream)>>>(n, static_cast<int*>(flags));
    return static_cast<int>(cudaGetLastError());
}
