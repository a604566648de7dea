// Kernel K5: the encoder's full-RD mode decision with reconstruction in the
// loop, with the trellis (methods 4-6) and per-MB segment parameters.
//
// Replaces webp_tpu/ops/encode_wavefront2.py:803 enc_step (with
// _i16_search_v2 :362, _i4_search_v2 :585, _uv_search_v2 :696,
// _chroma_diffusion_v2 :735, the rate model residual_costs_par :186, the
// trellis passes _i16_trellis_v2 :418 and _i4_trellis_v2 :467 over
// webp_tpu/ops/trellis2.py:110 trellis_par and :325 trellis_spec3, and the
// segment select _lane_params :292), driven over the MB grid by
// encode_analysis_batch_v2 :955.  The JAX step rates levels with one-hot
// matmuls, picks candidates with one-hot einsums and carries borders in
// ring buffers, all TPU workarounds; here rates are table lookups from
// shared memory, candidates are lanes, and neighbours are read back from
// the reconstruction planes the kernel writes.
//
// Bound: latency of the dependency chain.  An MB needs its left, top-left,
// top and top-right neighbours' reconstruction, so the mbw + 2(mbh-1)
// anti-diagonals t = x + 2y run one after another, and inside an MB the
// 16 I4 subblocks do too (each predicts from the previous ones' recon).
// Design: one block per image, one warp per MB row; at step t warp r
// decides MB (t - 2r, r), then the block synchronises.  In a warp the lanes
// split the work of an MB: I16 runs its 4 modes x 16 blocks as 64
// (mode, block) pairs, two per lane; I4 computes the ten B predictions on
// ten lanes and rates the n_try candidates on n_try lanes, subblock after
// subblock; UV runs its 4 modes x 2 planes x 4 blocks on the 32 lanes.
// Ties between scores go to the lowest mode (or candidate rank), as in the
// JAX kernel's argmin.
//
// Segments: the block keeps its image's four parameter sets in shared
// memory and each MB reads the set of its segment id.  Trellis (a
// template branch, so the kTrellis = false kernel has no trellis code):
// the decision stays the non-trellis search's; only the chosen luma path
// is quantized again.  I16 runs the DP of block b on lane b under all
// three entry contexts, then every lane resolves the real contexts block by
// block in raster order from the 3-bit nnz masks (shuffles); I4 re-runs
// the 16 subblocks on one lane with the modes fixed, each predicted from
// the trellis reconstruction.  The reconstruction follows the trellis, and
// each MB leaves the nnz of its final levels as a 16-bit mask for the
// entry contexts of the MBs below and to the right.

#include "common.cuh"
#include "trellis.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;       // score of a disallowed mode
constexpr int kMaxWarps = 32;

// EncParams.packed(), per segment: y1/y2/uv (iq, bias, q) vectors and the
// y1 sharpening in zigzag order, then the lambdas.
enum {
    P_Y1_IQ = 0, P_Y1_BIAS = 16, P_Y1_Q = 32, P_Y2_IQ = 48, P_Y2_BIAS = 64, P_Y2_Q = 80,
    P_UV_IQ = 96, P_UV_BIAS = 112, P_UV_Q = 128, P_Y1_SHARPEN = 144,
    P_LAMBDA_I16 = 160, P_LAMBDA_I4, P_LAMBDA_UV, P_LAMBDA_MODE, P_TLAMBDA,
    P_LAMBDA_TRELLIS_I16, P_LAMBDA_TRELLIS_I4, P_COUNT
};
constexpr int kSegments = 4;
// ops/enc_params.py CONSTS_NP: level fixed costs, I4/I16/UV mode costs, TDisto weights.
enum { C_FIXED = 0, C_FIXED_I4 = 2048, C_FIXED_I16 = 3048, C_FIXED_UV = 3052,
       C_WEIGHT_Y = 3056, C_COUNT = 3072 };
constexpr int kClsCount = 4 * 16 * 3 * 11;
constexpr int kEobCount = 4 * 16 * 3;

__constant__ int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
__constant__ int kBmodeOfI16[4] = {0, 2, 3, 1};  // DC/V/H/TM -> B_DC/B_VE/B_HE/B_TM

struct Tables {            // per image, in shared memory
    int params[kSegments][P_COUNT];
    uint16_t fixed[2048];  // sign + extra-bits cost per level
    uint16_t fixed_i4[1000];
    int fixed_i16[4], fixed_uv[4], weight_y[16];
    int cls[kClsCount];    // [ctype][pos][ctx][token class]
    int eob[kEobCount];    // [ctype][pos][ctx]
    int init[kEobCount];
};

struct WarpWs {            // per warp
    int y2[4][16];         // I16: the 16 luma DCs per mode, then their reconstruction
    int16_t y2lv[4][16];   // I16: Y2 levels per mode
    uint8_t ws[17][21];    // I4: [tl | above | above-right] row, left column, recon
    int sse[10];           // I4: prediction SSE per B mode
    int cdc[2][4];         // UV: DCs of the chosen mode for the error diffusion
};

__device__ __forceinline__ int rd_score(int rate, int disto, int lam) {
    // floor(rate * lam / 256) + disto with rate >> 8 capped so that the
    // product stays in int32 (the JAX _rd_score32 saturation).
    const int cap = (1 << 30) / (lam > 1 ? lam : 1);
    const int hi = min(rate >> 8, cap);
    return hi * lam + (((rate & 255) * lam) >> 8) + disto;
}

__device__ __forceinline__ int quant(int c, int iq, int bias) {
    const int a = c < 0 ? -c : c;
    const int level = min((a * iq + bias) >> 17, 2047);
    return c < 0 ? -level : level;
}

// Forward DCT of a row-major 4x4 residual (libwebp rounding).
__device__ void fdct4x4(const int* in, int* out) {
    int t[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int e0 = in[4 * i], e1 = in[4 * i + 1], e2 = in[4 * i + 2], e3 = in[4 * i + 3];
        const int a = (e0 + e3) * 8, b = (e1 + e2) * 8, c = (e1 - e2) * 8, d = (e0 - e3) * 8;
        t[4 * i] = a + b;
        t[4 * i + 1] = (c * 2217 + d * 5352 + 14500) >> 12;
        t[4 * i + 2] = a - b;
        t[4 * i + 3] = (d * 2217 - c * 5352 + 7500) >> 12;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c0 = t[j], c1 = t[4 + j], c2 = t[8 + j], c3 = t[12 + j];
        const int a = c0 + c3, b = c1 + c2, c = c1 - c2, d = c0 - c3;
        out[j] = (a + b + 7) >> 4;
        out[4 + j] = ((c * 2217 + d * 5352 + 12000) >> 16) + (d != 0);
        out[8 + j] = (a - b + 7) >> 4;
        out[12 + j] = (d * 2217 - c * 5352 + 51000) >> 16;
    }
}

__device__ __forceinline__ int half_round(int v) {
    return v >= 0 ? (v + (v > 0)) >> 1 : -((-v) >> 1);
}

// Forward WHT of the 16 luma DCs (raster block order).
__device__ void fwht4x4(const int* in, int* out) {
    int t[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int e0 = in[4 * i], e1 = in[4 * i + 1], e2 = in[4 * i + 2], e3 = in[4 * i + 3];
        t[4 * i] = (e0 + e3) + (e1 + e2);
        t[4 * i + 1] = (e1 - e2) + (e0 - e3);
        t[4 * i + 2] = (e0 + e3) - (e1 + e2);
        t[4 * i + 3] = (e0 - e3) - (e1 - e2);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c0 = t[j], c1 = t[4 + j], c2 = t[8 + j], c3 = t[12 + j];
        out[j] = half_round((c0 + c3) + (c1 + c2));
        out[4 + j] = half_round((c1 - c2) + (c0 - c3));
        out[8 + j] = half_round((c0 + c3) - (c1 + c2));
        out[12 + j] = half_round((c0 - c3) - (c1 - c2));
    }
}

// Weighted Hadamard energy of a row-major 4x4 block (TDisto).
__device__ int t_transform(const int* b, const int* w) {
    int t[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int e0 = b[4 * i], e1 = b[4 * i + 1], e2 = b[4 * i + 2], e3 = b[4 * i + 3];
        const int a0 = e0 + e2, a1 = e1 + e3, a2 = e1 - e3, a3 = e0 - e2;
        t[4 * i] = a0 + a1;
        t[4 * i + 1] = a3 + a2;
        t[4 * i + 2] = a3 - a2;
        t[4 * i + 3] = a0 - a1;
    }
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c0 = t[j], c1 = t[4 + j], c2 = t[8 + j], c3 = t[12 + j];
        const int a0 = c0 + c2, a1 = c1 + c3, a2 = c1 - c3, a3 = c0 - c2;
        sum += abs(a0 + a1) * w[j] + abs(a3 + a2) * w[4 + j] + abs(a3 - a2) * w[8 + j]
               + abs(a0 - a1) * w[12 + j];
    }
    return sum;
}

__device__ __forceinline__ int spectral(int tlambda, int td) {
    return tlambda > 0 ? (tlambda * td + 128) >> 8 : 0;
}

__device__ __forceinline__ int token_class(int vc) {
    return (vc >= 1) + (vc >= 2) + (vc >= 3) + (vc >= 4) + (vc >= 5) + (vc >= 7) + (vc >= 11)
           + (vc >= 19) + (vc >= 35) + (vc >= 67);
}

// GetResidualCost of one zigzag level block (ops/enc_costs.py).
__device__ int residual_cost(const int* lv, int ctype, int first, int ctx0, const Tables& T) {
    int last = -1;
    bool any = false;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
        if (lv[n] != 0) {
            last = n;
            any |= n >= first;
        }
    }
    const int base = ctype * 16 * 3;
    if (!any) return T.eob[base + first * 3 + ctx0];
    int cost = ctx0 == 0 ? T.init[base + first * 3] : 0;
    int ctx = ctx0;
    for (int n = first; n <= last; ++n) {
        const int v = abs(lv[n]);
        cost += T.cls[((base + n * 3 + ctx) * 11) + token_class(min(v, 67))] + T.fixed[min(v, 2047)];
        ctx = min(v, 2);
    }
    if (last < 15) cost += T.eob[base + (last + 1) * 3 + (abs(lv[last]) == 1 ? 1 : 2)];
    return cost;
}

// Levels of a raster coefficient block, and its dequantized raster form.
__device__ __forceinline__ void quant_block(const int* coef, const int* p, int iq, int bias,
                                            int* lv) {
#pragma unroll
    for (int z = 0; z < 16; ++z) lv[z] = quant(coef[kZigzag[z]], p[iq + z], p[bias + z]);
}

__device__ __forceinline__ void dequant_block(const int* lv, const int* p, int q, int* coef) {
#pragma unroll
    for (int z = 0; z < 16; ++z) coef[kZigzag[z]] = lv[z] * p[q + z];
}

__device__ __forceinline__ int warp_sum(int v, int width) {
    for (int off = width >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off, width);
    return v;
}

// Lane of the least value over the warp, the lowest lane among equals.
__device__ __forceinline__ int warp_argmin(int v, int lane) {
    int idx = lane;
    for (int off = 16; off > 0; off >>= 1) {
        const int ov = __shfl_xor_sync(kFull, v, off);
        const int oi = __shfl_xor_sync(kFull, idx, off);
        if (ov < v || (ov == v && oi < idx)) {
            v = ov;
            idx = oi;
        }
    }
    return idx;
}

struct Mb {
    int b, m, x, y, mbw, nmb;
    const int* P;                 // the parameters of the MB's segment
    const uint8_t *sy, *su, *sv;  // source planes of the image
    uint8_t *ry, *ru, *rv;        // reconstruction planes of the image
};

// I16 block (mode, blk) of MB `mb`: prediction and source pixels, row-major.
__device__ void i16_pred_src(const Mb& mb, int mode, int blk, int dc, int* pred, int* src) {
    const int W = mb.mbw * 16, y0 = mb.y * 16, x0 = mb.x * 16;
    const int br = (blk >> 2) * 4, bc = (blk & 3) * 4;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int r = br + (k >> 2), c = bc + (k & 3);
        pred[k] = predict_whole(mode, mb.ry, W, y0, x0, r, c, dc);
        src[k] = mb.sy[(y0 + r) * W + x0 + c];
    }
}

// The I16 search.  Leaves the Y2 levels of each mode in ws.y2lv and each
// mode's reconstructed DCs in ws.y2; returns the best mode and writes its
// score at lambda_mode to *score.
__device__ int i16_search(const Mb& mb, int lane, const Tables& T, WarpWs& ws, int* score) {
    const int* P = mb.P;
    const int W = mb.mbw * 16, y0 = mb.y * 16, x0 = mb.x * 16;
    const int dc = whole_dc(mb.ry, W, y0, x0, 16, 4);
    const int blk = lane & 15;
    int pred[16], src[16], coef[16], lv[16];
    // Pass A: the DCs of the 64 (mode, block) pairs, for the Y2 WHT.
    for (int j = 0; j < 2; ++j) {
        const int mode = (lane >> 4) + 2 * j;
        i16_pred_src(mb, mode, blk, dc, pred, src);
#pragma unroll
        for (int k = 0; k < 16; ++k) src[k] -= pred[k];
        fdct4x4(src, coef);
        ws.y2[mode][blk] = coef[0];
    }
    __syncwarp();
    if (lane < 4) {
        int in[16], y2[16], rec[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) in[k] = ws.y2[lane][k];
        fwht4x4(in, y2);
        quant_block(y2, P, P_Y2_IQ, P_Y2_BIAS, lv);
#pragma unroll
        for (int z = 0; z < 16; ++z) ws.y2lv[lane][z] = static_cast<int16_t>(lv[z]);
        dequant_block(lv, P, P_Y2_Q, in);
        iwht4x4(in, rec);
#pragma unroll
        for (int k = 0; k < 16; ++k) ws.y2[lane][k] = rec[k];
    }
    __syncwarp();
    // Pass B: AC levels, rate, reconstruction and distortion per pair;
    // sums over each half-warp's 16 blocks (lanes 0-15: modes 0 and 2,
    // lanes 16-31: modes 1 and 3).
    bool flat = true;
    const int v00 = mb.sy[y0 * W + x0];
    for (int k = lane; k < 256; k += 32) flat &= mb.sy[(y0 + (k >> 4)) * W + x0 + (k & 15)] == v00;
    flat = __all_sync(kFull, flat);
    int rate_m[4], dist_m[4], sc_m[4];
    for (int j = 0; j < 2; ++j) {
        const int mode = (lane >> 4) + 2 * j;
        int rec[16];
        i16_pred_src(mb, mode, blk, dc, pred, src);
#pragma unroll
        for (int k = 0; k < 16; ++k) rec[k] = src[k] - pred[k];
        fdct4x4(rec, coef);
        quant_block(coef, P, P_Y1_IQ, P_Y1_BIAS, lv);
        lv[0] = 0;
        int cost = residual_cost(lv, 0, 1, 0, T);
        int nz = 0;
#pragma unroll
        for (int z = 1; z < 16; ++z) nz += lv[z] != 0;
        dequant_block(lv, P, P_Y1_Q, coef);
        coef[0] = ws.y2[mode][blk];
        idct4x4(coef);
        int d = 0;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            rec[k] = clip255(pred[k] + coef[k]);
            d += (rec[k] - src[k]) * (rec[k] - src[k]);
        }
        int td = abs(t_transform(rec, T.weight_y) - t_transform(src, T.weight_y)) >> 5;
        cost = warp_sum(cost, 16);
        d = warp_sum(d, 16);
        td = warp_sum(td, 16);
        nz = warp_sum(nz, 16);
        // Lanes 0 and 16 now hold the sums of their mode.
        int m_rate = 0, m_dist = 0, m_score = kBig;
        if ((lane & 15) == 0) {
            int y2lv[16];
#pragma unroll
            for (int z = 0; z < 16; ++z) y2lv[z] = ws.y2lv[mode][z];
            int sd = spectral(P[P_TLAMBDA], td);
            if (flat && nz == 0) {
                d *= 2;
                sd *= 2;
            }
            m_rate = T.fixed_i16[mode] + residual_cost(y2lv, 1, 0, 0, T) + cost;
            m_dist = d + sd;
            const bool allowed = mode == 0 || (mode == 1 && mb.y > 0) || (mode == 2 && mb.x > 0)
                                 || (mode == 3 && mb.y > 0 && mb.x > 0);
            m_score = allowed ? rd_score(m_rate, m_dist, P[P_LAMBDA_I16]) : kBig;
        }
        for (int h = 0; h < 2; ++h) {
            rate_m[2 * j + h] = __shfl_sync(kFull, m_rate, 16 * h);
            dist_m[2 * j + h] = __shfl_sync(kFull, m_dist, 16 * h);
            sc_m[2 * j + h] = __shfl_sync(kFull, m_score, 16 * h);
        }
    }
    int best = 0;
    for (int m = 1; m < 4; ++m) best = sc_m[m] < sc_m[best] ? m : best;
    *score = rd_score(rate_m[best], dist_m[best], P[P_LAMBDA_MODE]);
    return best;
}

// Writes the I16 decision of mode `best` (levels, modes, reconstruction).
// With kTrellis, the 16 blocks' levels come from the trellis with the
// entry contexts of their top and left neighbours (top_nz: the nnz of the
// MB above's bottom row, bit x; left_nz: of the left MB's right column, bit
// y); returns the nnz mask of the levels from position 1 (bit 4y + x).
template <bool kTrellis>
__device__ unsigned i16_commit(const Mb& mb, int lane, int best, const Tables& T, WarpWs& ws,
                               unsigned top_nz, unsigned left_nz, uint8_t* bpred, int16_t* ylv,
                               int16_t* y2lv) {
    const int* P = mb.P;
    const int W = mb.mbw * 16, y0 = mb.y * 16, x0 = mb.x * 16;
    int pred[16], src[16], coef[16], lv[16];
    if (lane < 16) {
        const int dc = whole_dc(mb.ry, W, y0, x0, 16, 4);
        i16_pred_src(mb, best, lane, dc, pred, src);
#pragma unroll
        for (int k = 0; k < 16; ++k) src[k] -= pred[k];
        fdct4x4(src, coef);
    }
    unsigned nz_mask = 0;
    if (kTrellis) {
        TrellisBlock tb;
        TrellisPath path[3];
        unsigned nz3 = 0;  // bit c: the block has a nonzero level under entry context c
        if (lane < 16) {
            int czz[16];
#pragma unroll
            for (int z = 0; z < 16; ++z) czz[z] = coef[kZigzag[z]];
            trellis_prepare(czz, P + P_Y1_Q, P + P_Y1_SHARPEN, 1, tb);
            for (int c = 0; c < 3; ++c) {
                path[c] = trellis_dp(tb, P + P_Y1_Q, P + P_Y1_IQ, P[P_LAMBDA_TRELLIS_I16], 1, c,
                                     T.cls, T.eob, T.init, T.fixed);
                nz3 |= static_cast<unsigned>(path[c].best_n >= 0) << c;
            }
        }
        int my_ctx = 0;
        for (int bi = 0; bi < 16; ++bi) {  // the real contexts, in raster order
            const unsigned m3 = __shfl_sync(kFull, nz3, bi);
            const int bx = bi & 3, by = bi >> 2;
            const unsigned top = by == 0 ? top_nz >> bx : nz_mask >> (bi - 4);
            const unsigned left = bx == 0 ? left_nz >> by : nz_mask >> (bi - 1);
            const int ctx = static_cast<int>((top & 1) + (left & 1));
            nz_mask |= ((m3 >> ctx) & 1) << bi;
            if (lane == bi) my_ctx = ctx;
        }
        if (lane < 16) trellis_unwind(tb, path[my_ctx], P + P_Y1_IQ, 1, lv);
    } else if (lane < 16) {
        quant_block(coef, P, P_Y1_IQ, P_Y1_BIAS, lv);
        lv[0] = 0;
    }
    if (lane < 16) {
#pragma unroll
        for (int z = 0; z < 16; ++z) ylv[lane * 16 + z] = static_cast<int16_t>(lv[z]);
        dequant_block(lv, P, P_Y1_Q, coef);
        coef[0] = ws.y2[best][lane];
        idct4x4(coef);
        const int br = (lane >> 2) * 4, bc = (lane & 3) * 4;
#pragma unroll
        for (int k = 0; k < 16; ++k)
            mb.ry[(y0 + br + (k >> 2)) * W + x0 + bc + (k & 3)] =
                static_cast<uint8_t>(clip255(pred[k] + coef[k]));
        y2lv[lane] = ws.y2lv[best][lane];
        bpred[lane] = lane >= 12 ? kBmodeOfI16[best] : 0;
    }
    return nz_mask;
}

// The 13 edge pixels of I4 subblock (R0 / 4, C0 / 4) from the workspace:
// left column bottom-up, the corner, the eight above.
__device__ __forceinline__ void i4_edges(const WarpWs& ws, int R0, int C0, int* e) {
    e[0] = ws.ws[R0 + 4][C0];
    e[1] = ws.ws[R0 + 3][C0];
    e[2] = ws.ws[R0 + 2][C0];
    e[3] = ws.ws[R0 + 1][C0];
#pragma unroll
    for (int k = 0; k < 9; ++k) e[4 + k] = ws.ws[R0][C0 + k];
}

// The I4 trellis: the 16 subblocks again, on lane 0, with the modes the
// search chose, each predicted from the trellis reconstruction in ws.ws
// (whose borders the search left in place) and trellis-quantized with the
// entry context of its top and left neighbours (across the MB edge from
// top_nz / left_nz).  Returns the nnz mask of the levels (bit i).
__device__ unsigned i4_trellis(const Mb& mb, int lane, const Tables& T, WarpWs& ws,
                               unsigned top_nz, unsigned left_nz, const uint8_t* modes,
                               int16_t* ylv) {
    const int* P = mb.P;
    const int W = mb.mbw * 16, y0 = mb.y * 16, x0 = mb.x * 16;
    unsigned nz_mask = 0;
    if (lane == 0) {
        for (int i = 0; i < 16; ++i) {
            const int sby = i >> 2, sbx = i & 3, R0 = sby * 4, C0 = sbx * 4;
            int e[13], res[16], pred[16], coef[16], lv[16];
            i4_edges(ws, R0, C0, e);
            predict_b4(modes[i], e, pred);
#pragma unroll
            for (int k = 0; k < 16; ++k)
                res[k] = mb.sy[(y0 + R0 + (k >> 2)) * W + x0 + C0 + (k & 3)] - pred[k];
            fdct4x4(res, coef);
#pragma unroll
            for (int z = 0; z < 16; ++z) res[z] = coef[kZigzag[z]];
            TrellisBlock tb;
            trellis_prepare(res, P + P_Y1_Q, P + P_Y1_SHARPEN, 0, tb);
            const unsigned top = sby == 0 ? top_nz >> sbx : nz_mask >> (i - 4);
            const unsigned left = sbx == 0 ? left_nz >> sby : nz_mask >> (i - 1);
            const TrellisPath path =
                trellis_dp(tb, P + P_Y1_Q, P + P_Y1_IQ, P[P_LAMBDA_TRELLIS_I4], 0,
                           static_cast<int>((top & 1) + (left & 1)), T.cls + 3 * 16 * 3 * 11,
                           T.eob + 3 * 16 * 3, T.init + 3 * 16 * 3, T.fixed);
            trellis_unwind(tb, path, P + P_Y1_IQ, 0, lv);
            nz_mask |= static_cast<unsigned>(path.best_n >= 0) << i;
#pragma unroll
            for (int z = 0; z < 16; ++z) ylv[i * 16 + z] = static_cast<int16_t>(lv[z]);
            dequant_block(lv, P, P_Y1_Q, coef);
            idct4x4(coef);
#pragma unroll
            for (int q = 0; q < 16; ++q)
                ws.ws[R0 + 1 + (q >> 2)][C0 + 1 + (q & 3)] =
                    static_cast<uint8_t>(clip255(pred[q] + coef[q]));
        }
    }
    return __shfl_sync(kFull, nz_mask, 0);
}

// The I4 search over the 16 subblocks.  Writes each subblock's chosen
// mode and levels to bpred / ylv and keeps the reconstruction in ws.ws;
// returns whether I4 beats i16_score.
__device__ bool i4_search(const Mb& mb, int lane, int n_try, int i16_score, const Tables& T,
                          WarpWs& ws, const uint8_t* lmode, const uint8_t* bpred_all,
                          uint8_t* bpred, int16_t* ylv) {
    const int* P = mb.P;
    const int W = mb.mbw * 16, y0 = mb.y * 16, x0 = mb.x * 16;
    // Bordered workspace: row 0 = [tl | 16 above | 4 above-right], column
    // 0 = left; column-3 subblocks of rows 4/8/12 reuse the MB's above-right.
    for (int k = lane; k < 21; k += 32) {
        int v;
        if (k == 0) {
            v = pix(mb.ry, W, y0 - 1, x0 - 1);
        } else if (k <= 16) {
            v = pix(mb.ry, W, y0 - 1, x0 + k - 1);
        } else if (mb.y == 0) {
            v = 127;
        } else {
            v = mb.ry[(y0 - 1) * W + (mb.x == mb.mbw - 1 ? x0 + 15 : x0 + 16 + k - 17)];
        }
        ws.ws[0][k] = static_cast<uint8_t>(v);
        if (k >= 17) ws.ws[4][k] = ws.ws[8][k] = ws.ws[12][k] = static_cast<uint8_t>(v);
    }
    if (lane < 16) ws.ws[1 + lane][0] = static_cast<uint8_t>(pix(mb.ry, W, y0 + lane, x0 - 1));
    // Neighbour B-mode contexts: an I16 MB's bpred row 12..15 carries its
    // mapped mode, and its luma mode gives the right column.
    int tb[4], lb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        tb[k] = mb.y > 0 ? bpred_all[(mb.m - mb.mbw) * 16 + 12 + k] : 0;
        lb[k] = 0;
        if (mb.x > 0) {
            const int left = mb.m - 1;
            lb[k] = lmode[left] == 4 ? bpred_all[left * 16 + 4 * k + 3] : bpred_all[left * 16 + 12];
        }
    }
    int tnz[4] = {0, 0, 0, 0}, lnz[4] = {0, 0, 0, 0};
    int rate = 211, disto = 0, tmc = 0;  // 211: the B-mode header's initial penalty
    bool ok = true;
    __syncwarp();
    for (int i = 0; i < 16; ++i) {
        const int sby = i >> 2, sbx = i & 3, R0 = sby * 4, C0 = sbx * 4;
        int e[13], src[16];
        i4_edges(ws, R0, C0, e);
#pragma unroll
        for (int k = 0; k < 16; ++k) src[k] = mb.sy[(y0 + R0 + (k >> 2)) * W + x0 + C0 + (k & 3)];
        int pred[16];
        if (lane < 10) {
            predict_b4(lane, e, pred);
            int sse = 0;
#pragma unroll
            for (int k = 0; k < 16; ++k) sse += (pred[k] - src[k]) * (pred[k] - src[k]);
            ws.sse[lane] = sse;
        }
        __syncwarp();
        // Candidates in rank order: DC first (unless all ten are tried), then
        // the B modes of least SSE, ties to the lower mode.
        int cur[10], my_mode = 0;
#pragma unroll
        for (int k = 0; k < 10; ++k) cur[k] = ws.sse[k];
        int rank = 0;
        if (n_try < 10) {
            cur[0] = kBig;
            rank = 1;
        }
        for (; rank < n_try; ++rank) {
            int m = 0;
#pragma unroll
            for (int k = 1; k < 10; ++k) m = cur[k] < cur[m] ? k : m;
            cur[m] = kBig;
            if (lane == rank) my_mode = m;
        }
        int score = 0x7fffffff, rates = 0, dist = 0, mc = 0, has = 0;
        int lv[16], rec[16];
        if (lane < n_try) {
            int coef[16];
            predict_b4(my_mode, e, pred);
#pragma unroll
            for (int k = 0; k < 16; ++k) rec[k] = src[k] - pred[k];
            fdct4x4(rec, coef);
            quant_block(coef, P, P_Y1_IQ, P_Y1_BIAS, lv);
            const int ctx0 = (sby > 0 ? tnz[sbx] : 0) + (sbx > 0 ? lnz[sby] : 0);
            const int cc = residual_cost(lv, 3, 0, ctx0, T);
            dequant_block(lv, P, P_Y1_Q, coef);
            idct4x4(coef);
            int d = 0;
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                rec[k] = clip255(pred[k] + coef[k]);
                d += (rec[k] - src[k]) * (rec[k] - src[k]);
            }
            const int td = abs(t_transform(rec, T.weight_y) - t_transform(src, T.weight_y)) >> 5;
            mc = T.fixed_i4[(tb[sbx] * 10 + lb[sby]) * 10 + my_mode];
            rates = cc + mc;
            dist = d + spectral(P[P_TLAMBDA], td);
            score = rd_score(rates, dist, P[P_LAMBDA_I4]);
#pragma unroll
            for (int z = 0; z < 16; ++z) has |= lv[z] != 0;
        }
        const int k = warp_argmin(score, lane);
        if (lane == k) {
#pragma unroll
            for (int q = 0; q < 16; ++q) {
                ws.ws[R0 + 1 + (q >> 2)][C0 + 1 + (q & 3)] = static_cast<uint8_t>(rec[q]);
                ylv[i * 16 + q] = static_cast<int16_t>(lv[q]);
            }
            bpred[i] = static_cast<uint8_t>(my_mode);
        }
        const int m = __shfl_sync(kFull, my_mode, k);
        tb[sbx] = lb[sby] = m;
        tnz[sbx] = lnz[sby] = __shfl_sync(kFull, has, k);
        rate += __shfl_sync(kFull, rates, k);
        disto += __shfl_sync(kFull, dist, k);
        tmc += __shfl_sync(kFull, mc, k);
        ok = ok && rd_score(rate, disto, P[P_LAMBDA_MODE]) < i16_score && tmc <= 256 * 16 * 16 / 4;
        __syncwarp();
    }
    return ok;
}

// One step of the chroma DC error diffusion: the DC becomes its quantized
// reconstruction (libwebp's QuantizeSingle); returns the halved error.
__device__ int diffuse_dc(int& dc, int t_err, int l_err, int q, int iq, int bias) {
    const int d2 = dc + ((7 * t_err + 8 * l_err) >> 3);
    const int a = abs(d2);
    const int qv = ((a * iq + bias) >> 17) * q;
    dc = d2 < 0 ? -qv : qv;
    const int err = d2 < 0 ? qv - a : a - qv;
    return max(-127, min(127, err >> 1));
}

// UV search, chroma DC diffusion and the chosen mode's levels and
// reconstruction.  Lane = mode * 8 + plane * 4 + block.  Returns the mode.
__device__ int uv_search(const Mb& mb, int lane, const Tables& T, WarpWs& ws, int* errs,
                         int16_t* uvlv) {
    const int* P = mb.P;
    const int CW = mb.mbw * 8, cy0 = mb.y * 8, cx0 = mb.x * 8;
    const int mode = lane >> 3, ch = (lane >> 2) & 1, blk = lane & 3;
    const int br = (blk >> 1) * 4, bc = (blk & 1) * 4;
    uint8_t* C = ch ? mb.rv : mb.ru;
    const uint8_t* S = ch ? mb.sv : mb.su;
    const int dc = whole_dc(C, CW, cy0, cx0, 8, 3);
    int pred[16], src[16], coef[16], lv[16], rec[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int r = br + (k >> 2), c = bc + (k & 3);
        pred[k] = predict_whole(mode, C, CW, cy0, cx0, r, c, dc);
        src[k] = S[(cy0 + r) * CW + cx0 + c];
        rec[k] = src[k] - pred[k];
    }
    fdct4x4(rec, coef);
    quant_block(coef, P, P_UV_IQ, P_UV_BIAS, lv);
    int nz = 0;
#pragma unroll
    for (int z = 1; z < 16; ++z) nz += lv[z] != 0;
    int cost = residual_cost(lv, 2, 0, 0, T);
    int res[16];
    dequant_block(lv, P, P_UV_Q, res);
    idct4x4(res);
    int d = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int r = clip255(pred[k] + res[k]);
        d += (r - src[k]) * (r - src[k]);
    }
    cost = warp_sum(cost, 8);
    d = warp_sum(d, 8);
    nz = warp_sum(nz, 8);
    int score = 0x7fffffff;
    if ((lane & 7) == 0) {
        int rate = T.fixed_uv[mode] + cost;
        if (mode != 0 && nz <= 2) rate += 140 * 8;  // flatness penalty
        const bool allowed = mode == 0 || (mode == 1 && mb.y > 0) || (mode == 2 && mb.x > 0)
                             || (mode == 3 && mb.y > 0 && mb.x > 0);
        score = allowed ? rd_score(rate, d, P[P_LAMBDA_UV]) : kBig;
    }
    const int best = warp_argmin(score, lane) >> 3;

    // Chroma DC error diffusion (C1 = 7, C2 = 8) over the chosen mode's
    // blocks: QuantizeSingle replaces each DC by its reconstruction.
    if (mode == best) ws.cdc[ch][blk] = coef[0];
    __syncwarp();
    if (lane < 2) {
        const int q = P[P_UV_Q], iq = P[P_UV_IQ], bias = P[P_UV_BIAS];
        const long long base = static_cast<long long>(mb.b) * mb.nmb;
        int te[2] = {0, 0}, le[2] = {0, 0};
        for (int k = 0; k < 2; ++k) {
            if (mb.y > 0) te[k] = errs[(base + mb.m - mb.mbw) * 8 + lane * 2 + k];
            if (mb.x > 0) le[k] = errs[(base + mb.m - 1) * 8 + 4 + lane * 2 + k];
        }
        int* dc = ws.cdc[lane];
        const int e0 = diffuse_dc(dc[0], te[0], le[0], q, iq, bias);
        const int e1 = diffuse_dc(dc[1], te[1], e0, q, iq, bias);
        const int e2 = diffuse_dc(dc[2], e0, le[1], q, iq, bias);
        const int e3 = diffuse_dc(dc[3], e1, e2, q, iq, bias);
        const int nl1 = (3 * e3) >> 2;
        int* out = errs + (base + mb.m) * 8;  // [top error of U, V][2], then [left ...][2]
        out[lane * 2] = e2;
        out[lane * 2 + 1] = e3 - nl1;
        out[4 + lane * 2] = e1;
        out[4 + lane * 2 + 1] = nl1;
    }
    __syncwarp();
    if (mode == best) {
        coef[0] = ws.cdc[ch][blk];
        quant_block(coef, P, P_UV_IQ, P_UV_BIAS, lv);
#pragma unroll
        for (int z = 0; z < 16; ++z) uvlv[(ch * 4 + blk) * 16 + z] = static_cast<int16_t>(lv[z]);
        dequant_block(lv, P, P_UV_Q, res);
        idct4x4(res);
        for (int k = 0; k < 16; ++k)
            C[(cy0 + br + (k >> 2)) * CW + cx0 + bc + (k & 3)] =
                static_cast<uint8_t>(clip255(pred[k] + res[k]));
    }
    return best;
}

template <bool kTrellis>
__global__ void __launch_bounds__(1024) enc_kernel(
    const uint8_t* __restrict__ y, long long y_bs, const uint8_t* __restrict__ u, long long u_bs,
    const uint8_t* __restrict__ v, long long v_bs, const int* __restrict__ params,
    long long params_bs, const uint8_t* __restrict__ sid, long long sid_bs,
    const int* __restrict__ consts, const int* __restrict__ cls, long long cls_bs,
    const int* __restrict__ eob, long long eob_bs, const int* __restrict__ init, long long init_bs,
    int mbw, int mbh, int n_try, uint8_t* lmode, uint8_t* cmode, uint8_t* bpred,
    int16_t* ylv, int16_t* y2lv, int16_t* uvlv, uint8_t* recon, int* errs, int* nnz) {
    __shared__ Tables T;
    __shared__ WarpWs wss[kMaxWarps];
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    for (int k = threadIdx.x; k < kSegments * P_COUNT; k += blockDim.x)
        (&T.params[0][0])[k] = params[b * params_bs + k];
    for (int k = threadIdx.x; k < 2048; k += blockDim.x) T.fixed[k] = consts[C_FIXED + k];
    for (int k = threadIdx.x; k < 1000; k += blockDim.x) T.fixed_i4[k] = consts[C_FIXED_I4 + k];
    for (int k = threadIdx.x; k < 4; k += blockDim.x) {
        T.fixed_i16[k] = consts[C_FIXED_I16 + k];
        T.fixed_uv[k] = consts[C_FIXED_UV + k];
    }
    for (int k = threadIdx.x; k < 16; k += blockDim.x) T.weight_y[k] = consts[C_WEIGHT_Y + k];
    for (int k = threadIdx.x; k < kClsCount; k += blockDim.x) T.cls[k] = cls[b * cls_bs + k];
    for (int k = threadIdx.x; k < kEobCount; k += blockDim.x) {
        T.eob[k] = eob[b * eob_bs + k];
        T.init[k] = init[b * init_bs + k];
    }
    __syncthreads();

    const int nmb = mbw * mbh;
    const long long H = mbh * 16LL, W = mbw * 16LL;
    Mb mb;
    mb.b = b;
    mb.mbw = mbw;
    mb.nmb = nmb;
    mb.sy = y + b * y_bs;
    mb.su = u + b * u_bs;
    mb.sv = v + b * v_bs;
    mb.ry = recon + b * (H * W * 3 / 2);
    mb.ru = mb.ry + H * W;
    mb.rv = mb.ru + H * W / 4;
    const long long img = static_cast<long long>(b) * nmb;
    WarpWs& ws = wss[warp];
    const int T_ = wavefront_steps(mbw, mbh);
    for (int t = 0; t < T_; ++t) {
        for (int r = warp; r < mbh; r += nwarps) {
            const int x = t - 2 * r;
            if (x < 0 || x >= mbw) continue;
            mb.x = x;
            mb.y = r;
            mb.m = r * mbw + x;
            mb.P = T.params[sid ? sid[b * sid_bs + mb.m] & 3 : 0];
            const long long m = img + mb.m;
            // Trellis entry contexts across the MB edge: the nnz of the MB
            // above's bottom row (bit x) and of the left MB's right column (bit y).
            unsigned top_nz = 0, left_nz = 0;
            if (kTrellis) {
                if (r > 0) top_nz = (static_cast<unsigned>(nnz[m - mbw]) >> 12) & 15;
                if (x > 0) {
                    const unsigned l = static_cast<unsigned>(nnz[m - 1]);
                    left_nz = ((l >> 3) & 1) | ((l >> 6) & 2) | ((l >> 9) & 4) | ((l >> 12) & 8);
                }
            }
            int i16_score;
            const int best16 = i16_search(mb, lane, T, ws, &i16_score);
            bool use_i4 = false;
            if (n_try > 0) {
                use_i4 = i4_search(mb, lane, n_try, i16_score, T, ws, lmode + img, bpred + img * 16,
                                   bpred + m * 16, ylv + m * 256);
            }
            if (use_i4) {
                if (kTrellis) {
                    const unsigned nz = i4_trellis(mb, lane, T, ws, top_nz, left_nz,
                                                   bpred + m * 16, ylv + m * 256);
                    if (lane == 0) nnz[m] = static_cast<int>(nz);
                    __syncwarp();
                }
                if (lane < 16) {
                    const int W_ = mbw * 16;
                    for (int k = 0; k < 16; ++k)
                        mb.ry[(r * 16 + lane) * W_ + x * 16 + k] = ws.ws[1 + lane][1 + k];
                    y2lv[m * 16 + lane] = 0;
                }
                if (lane == 0) lmode[m] = 4;
            } else {
                const unsigned nz = i16_commit<kTrellis>(mb, lane, best16, T, ws, top_nz, left_nz,
                                                         bpred + m * 16, ylv + m * 256,
                                                         y2lv + m * 16);
                if (kTrellis && lane == 0) nnz[m] = static_cast<int>(nz);
                if (lane == 0) lmode[m] = static_cast<uint8_t>(best16);
            }
            const int uv = uv_search(mb, lane, T, ws, errs, uvlv + m * 128);
            if (lane == 0) cmode[m] = static_cast<uint8_t>(uv);
            __syncwarp();
        }
        __syncthreads();
    }
}

}  // namespace

WEBP_API int webp_enc(const void* y, long long y_bs, const void* u, long long u_bs, const void* v,
                      long long v_bs, const void* params, long long params_bs, const void* sid,
                      long long sid_bs, const void* consts, const void* cls, long long cls_bs,
                      const void* eob, long long eob_bs, const void* init, long long init_bs,
                      int mbw, int mbh, int batch, int n_try, int do_trellis, void* lmode,
                      void* cmode, void* bpred, void* ylv, void* y2lv, void* uvlv, void* recon,
                      void* errs, void* nnz, void* stream) {
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    auto kernel = do_trellis ? enc_kernel<true> : enc_kernel<false>;
    kernel<<<batch, wavefront_threads(mbh), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), y_bs, static_cast<const uint8_t*>(u), u_bs,
        static_cast<const uint8_t*>(v), v_bs, static_cast<const int*>(params), params_bs,
        static_cast<const uint8_t*>(sid), sid_bs, static_cast<const int*>(consts),
        static_cast<const int*>(cls), cls_bs, static_cast<const int*>(eob), eob_bs,
        static_cast<const int*>(init), init_bs, mbw, mbh, n_try, static_cast<uint8_t*>(lmode),
        static_cast<uint8_t*>(cmode), static_cast<uint8_t*>(bpred), static_cast<int16_t*>(ylv),
        static_cast<int16_t*>(y2lv), static_cast<int16_t*>(uvlv), static_cast<uint8_t*>(recon),
        static_cast<int*>(errs), static_cast<int*>(nnz));
    return static_cast<int>(cudaGetLastError());
}
