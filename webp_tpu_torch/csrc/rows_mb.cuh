// The decode's row pipeline: one MB row of reconstruction and / or loop
// filter, walked left to right by a team of threads with its MB in
// shared-memory tiles, and gated on the row above through a progress
// counter.  The kernels that run it (K2, K3 and the fused recon_filter in
// wavefront_rows.cu, a team a CTA; K16 and K17 in banded.cu, a team a warp
// of a band's CTA) differ only in where the counters live, and so in the
// team's `Link`: how its first thread waits for the row above, how the team
// meets at a barrier, and how its first thread publishes the row's
// progress.
//
// Dependencies (a pixel "of" an MB lies in its 16x16; the full argument,
// with the fused kernel's, is wavefront_rows.cu's head comment):
// - Recon of (x, y) reads UNFILTERED pixels: the bottom row of (x-1..x+1,
//   y-1) and the right column of (x-1, y); the row above's bottom pixels
//   come from the per-row edge buffer in device memory, the left MB's
//   right column from shared memory.
// - The filter of (x, y) needs (x-1, y), (x, y-1) and (x+1, y-1) fully
//   filtered and writes 3 rows into (x, y-1) and 3 columns into (x-1, y).
// So iteration i of row r starts once row r-1 has finished min(i + 2,
// iterations), and row r-1 touches none of the pixels that iteration reads
// or writes after publishing i + 2.
//
// An iteration has three phases between team barriers.  Loads: the edges
// from the row above (recon); the 4 filtered rows above the filtered MB
// (and for K3 alone the MB itself) into its filter tiles.  Compute: the
// recon puts I16 and chroma pixels across its threads and runs a
// B-predicted MB's 16 subblocks as their own 10-step wavefront (t = sbx +
// 2 sby, one subblock a half-warp of warp 0) while the team's other recon
// warps, if any, do chroma; the recon threads also fetch the next MB's
// residues (cp.async into shared memory) and B modes, off the chain.  The filter runs on
// one warp on a 20x20 (chroma 12x12) tile with 4 margin rows above and
// columns left, double-buffered between MBs, one line a lane (16 luma, 8 U,
// 8 V) held in registers, each edge through the branch-free filter_w.
// Stores: the MB's unfiltered bottom row to the edge buffer, the tiles back
// to the planes.
//
// Memory model: pixels another team wrote are read with __ldcg after the
// acquire; the planes are never read through a const __restrict__ pointer,
// which the compiler may turn into ld.global.nc.
#pragma once

#include "filter_mb.cuh"

namespace {

constexpr int kTileY = 20;  // luma filter tile: 4 margin + 16
constexpr int kTileC = 12;  // chroma: 4 + 8

// One team's working MB.
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
// edge, then the inner ones): RFC 6386 15's order, in which each of the 8
// edge steps touches a line only through the line's own pixels.
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

// f(k) for k = tid, tid + kTeam, ... below kN: a team's share of kN
// items, unrolled (one call a thread when the team has kN threads), so that
// a thread's loads are all in flight at once.
template <int kN, int kTeam, class F>
__device__ __forceinline__ void for_team(int tid, F&& f) {
#pragma unroll
    for (int j = 0; j < (kN + kTeam - 1) / kTeam; ++j) {
        const int k = tid + j * kTeam;
        if (kN % kTeam == 0 || k < kN) f(k);
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
    int* prog;      // K2 / K3 / fused: [batch * mbh] finished MBs of each row, then the row ticket
};

// Row r of image b by a team of kTeam threads (tid its thread), on the
// team's tiles S.  Iteration i reconstructs MB i (kRecon) and filters MB
// f = i - kLag (kFilter): with both, the team's last warp filters MB i - 1
// while its other warps reconstruct MB i, so the row runs mbw + 1
// iterations.  Iteration i waits (link.wait, on thread 0) for the row
// above to have finished min(i + 2, iterations); after it, thread 0
// publishes i + 1 (link.publish); link.sync is the team's barrier.
template <bool kRecon, bool kFilter, int kTeam, class Link>
__device__ __forceinline__ void run_row(const Args& a, Shared& S, int tid, int b, int r,
                                        const Link& link) {
    constexpr int kLag = kRecon && kFilter ? 1 : 0;
    constexpr int kReconThreads = kRecon && kFilter ? kTeam - 32 : kTeam;
    constexpr int kFilterWarp = kRecon ? kTeam / 32 - 1 : 0;
    static_assert(kTeam % 32 == 0 && (!kRecon || kReconThreads >= 32), "a team is whole warps");
    const int warp = tid >> 5, lane = tid & 31;
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
    const int y0 = r * 16, cy0 = r * 8;
    const int32_t* res_row =  // the row's residues and B modes (recon)
        kRecon ? a.res + (static_cast<long long>(b) * nmb + r * mbw) * 24 * 16 : nullptr;
    const uint8_t* bp_row = kRecon ? a.bpred + b * a.bp_bs + r * mbw * 16 : nullptr;
    if (kRecon && tid < 16) {  // the left column of the row's first MB
        S.wy[1 + tid][0] = 129;
        S.wc[tid >> 3][1 + (tid & 7)][0] = 129;
    }
    if (kRecon) {  // MB 0's residues and B modes
        for_team<24 * 16, kTeam>(tid, [&](int k) { S.rs[0][k] = __ldg(res_row + k); });
        if (tid < 16) S.bp[0][tid] = __ldg(bp_row + tid);
    }
    const int n_iter = mbw + kLag;

    for (int i = 0; i < n_iter; ++i) {
        if (tid == 0 && r > 0) link.wait(min(i + 2, n_iter));
        link.sync();
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
            for_team<21 + 18, kTeam>(tid, [&](int k) {
                int val = 127;
                if (k < 21) {
                    if (r > 0) {
                        if (k == 0) val = i == 0 ? 129 : __ldcg(above + x0 - 1);
                        else if (k <= 16) val = __ldcg(above + x0 + k - 1);
                        else val = __ldcg(above + (i == mbw - 1 ? x0 + 15 : x0 + k - 1));
                    }
                    S.wy[0][k] = static_cast<uint8_t>(val);
                } else {
                    const int p = (k - 21) / 9, c = (k - 21) % 9;
                    if (r > 0) {
                        const uint8_t* ac = above + W + p * (W / 2);
                        val = c == 0 ? (i == 0 ? 129 : __ldcg(ac + cx0 - 1)) : __ldcg(ac + cx0 + c - 1);
                    }
                    S.wc[p][0][c] = static_cast<uint8_t>(val);
                }
            });
        }
        if (filt) {
            if (r > 0) {
                for_team<128, kTeam>(tid, [&](int k) {
                    if (k < 64) {
                        const int j = k >> 4, c = k & 15;
                        ty[j][4 + c] = __ldcg(Y + (y0 - 4 + j) * W + fx0 + c);
                    } else if (cfilt) {
                        const int p = (k - 64) >> 5, j = (k >> 3) & 3, c = k & 7;
                        tc[p][j][4 + c] = __ldcg((p ? V : U) + (cy0 - 4 + j) * CW + fcx0 + c);
                    }
                });
            }
            if (!kRecon) {
                for_team<256, kTeam>(tid, [&](int k) {
                    ty[4 + (k >> 4)][4 + (k & 15)] = __ldcg(Y + (y0 + (k >> 4)) * W + fx0 + (k & 15));
                });
                if (cfilt) {
                    for_team<128, kTeam>(tid, [&](int k) {
                        const int p = k >> 6, j = (k >> 3) & 7, c = k & 7;
                        tc[p][4 + j][4 + c] = __ldcg((p ? V : U) + (cy0 + j) * CW + fcx0 + c);
                    });
                }
            }
        }
        link.sync();

        // 2. Recon of MB i into the workspaces (and its filter tiles) on the
        //    first kReconThreads threads, which also fetch MB i + 1's residues
        //    (cp.async into the other slot) and B modes; the filter of MB f on
        //    warp kFilterWarp.
        if (rec && tid < kReconThreads) {
            const int cur = i & 1;
            const bool more = i + 1 < mbw;
            if (more) {
                const int32_t* next = res_row + (i + 1) * 24 * 16;
                for_team<24 * 16, kReconThreads>(tid, [&](int k) {
                    cp_async4(reinterpret_cast<uint32_t*>(&S.rs[cur ^ 1][k]),
                              reinterpret_cast<const uint32_t*>(next + k));
                });
                cp_async_commit();
            }
            const int bp_next = more && tid < 16 ? __ldg(bp_row + (i + 1) * 16 + tid) : 0;
            const int lm = a.lmode[b * a.lm_bs + m], cm = a.cmode[b * a.cm_bs + m];
            const int* rs = S.rs[cur];
            const int dcu = cm == 0 ? ws_dc(&S.wc[0][0][0], 9, 8, 3, r > 0, i > 0) : 0;
            const int dcv = cm == 0 ? ws_dc(&S.wc[1][0][0], 9, 8, 3, r > 0, i > 0) : 0;
            // Chroma pixels of this thread: all recon threads', but in a
            // B-predicted MB of a team of several recon warps, the warps
            // other than warp 0, which runs the subblocks meanwhile.
            int first_c = tid, step_c = kReconThreads;
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
                    if (kReconThreads > 32) step_c = 0;
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
                cp_async_wait<0>();
                if (tid < 16) S.bp[cur ^ 1][tid] = static_cast<uint8_t>(bp_next);
            }
        }
        const int lvl = filt ? a.level[b * a.lv_bs + mf] : 0;
        if (filt && warp == kFilterWarp && lvl != 0)
            filter_tile(lane, f > 0, r > 0, simple, lvl, a.interior[b * a.it_bs + mf],
                        a.hev[b * a.hv_bs + mf], a.do_sub[b * a.ds_bs + mf] != 0, &ty[0][0],
                        &tc[0][0][0], &tc[1][0][0]);
        link.sync();

        // 3. Stores: MB i's unfiltered bottom row for the row below, its right
        //    column as MB i + 1's left, and the pixels no filter changes; the
        //    tiles of MB f back to the planes (the MB, the rows above and the
        //    left MB's columns the filter changed), its last 4 columns the
        //    left margin of MB f + 1's tiles.  Without the filter (K2, K16)
        //    the row below reads only the edge buffer, so the MB goes to the
        //    planes after the publish, off the chain.
        if (rec) {
            if (tid < 16) {
                mine[x0 + tid] = S.wy[16][1 + tid];
                S.wy[1 + tid][0] = S.wy[1 + tid][16];
            } else if (tid < 32) {
                const int p = (tid - 16) >> 3, c = tid & 7;
                mine[W + p * (W / 2) + cx0 + c] = S.wc[p][8][1 + c];
                S.wc[p][1 + c][0] = S.wc[p][1 + c][8];
            }
            if (kFilter && simple) {  // chroma that no filter changes
                for_team<128, kTeam>(tid, [&](int k) {
                    const int pl = k >> 6, pr = (k >> 3) & 7, pc = k & 7;
                    (pl ? V : U)[(cy0 + pr) * CW + cx0 + pc] = S.wc[pl][1 + pr][1 + pc];
                });
            }
        }
        if (filt) {
            const bool on = lvl != 0;
            uint8_t(*ny)[kTileY] = S.fy[(f + 1) & 1];
            uint8_t(*nc)[kTileC][kTileC] = S.fc[(f + 1) & 1];
            if (kRecon || on) {
                for_team<256, kTeam>(tid, [&](int p) {
                    Y[(y0 + (p >> 4)) * W + fx0 + (p & 15)] = ty[4 + (p >> 4)][4 + (p & 15)];
                });
                if (cfilt) {
                    for_team<128, kTeam>(tid, [&](int k) {
                        const int pl = k >> 6, pr = (k >> 3) & 7, pc = k & 7;
                        (pl ? V : U)[(cy0 + pr) * CW + fcx0 + pc] = tc[pl][4 + pr][4 + pc];
                    });
                }
            }
            if (on && r > 0) {
                for_team<96, kTeam>(tid, [&](int k) {
                    if (k < 48) {
                        const int j = 1 + k / 16, c = k & 15;
                        Y[(y0 - 4 + j) * W + fx0 + c] = ty[j][4 + c];
                    } else if (cfilt) {
                        const int p = (k - 48) / 24, j = 1 + ((k - 48) % 24) / 8, c = k & 7;
                        (p ? V : U)[(cy0 - 4 + j) * CW + fcx0 + c] = tc[p][j][4 + c];
                    }
                });
            }
            for_team<128, kTeam>(tid, [&](int k) {
                if (k < 64) {
                    const int j = k >> 2, c = k & 3;
                    if (on && f > 0 && c > 0) Y[(y0 + j) * W + fx0 - 4 + c] = ty[4 + j][c];
                    ny[4 + j][c] = ty[4 + j][16 + c];
                } else if (cfilt) {
                    const int p = (k - 64) >> 5, j = (k >> 2) & 7, c = k & 3;
                    if (on && f > 0 && c > 0) (p ? V : U)[(cy0 + j) * CW + fcx0 - 4 + c] = tc[p][4 + j][c];
                    nc[p][4 + j][c] = tc[p][4 + j][8 + c];
                }
            });
        }
        link.sync();
        if (tid == 0) link.publish(i + 1);
        if (!kFilter && rec) {  // K2, K16: the MB as it is
            for_team<256, kTeam>(tid, [&](int p) {
                Y[(y0 + (p >> 4)) * W + x0 + (p & 15)] = S.wy[1 + (p >> 4)][1 + (p & 15)];
            });
            for_team<128, kTeam>(tid, [&](int k) {
                const int pl = k >> 6, pr = (k >> 3) & 7, pc = k & 7;
                (pl ? V : U)[(cy0 + pr) * CW + cx0 + pc] = S.wc[pl][1 + pr][1 + pc];
            });
        }
    }
}

}  // namespace
