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
// shared memory, candidates are lanes, and neighbours are the edge pixels
// that the row above leaves in device memory and the MB to the left in
// shared memory.
//
// Bound: latency of the dependency chain.  An MB needs its left, top-left,
// top and top-right neighbours' reconstruction, so an image's MBs form a
// chain of about mbw + 2(mbh-1) MB latencies; inside an MB the 16 I4
// subblocks form the same kind of wavefront (10 steps).
//
// Launch: one CTA of four warps per (image, MB row) over the whole card.  A
// CTA takes its row from a ticket (an atomic counter the wrapper zeroes),
// rows in order of height, so it only ever waits on rows whose CTAs
// already run: no cooperative launch, no deadlock.  MB (x, r) starts when
// row r-1's progress counter reaches min(x + 2, mbw) (the top-right
// dependency); thread 0 polls it with ld.acquire.gpu, and neighbour data of
// other CTAs is read through L2 (__ldcg).  After an MB's writes thread 0
// publishes x + 1 with a fence and st.release.gpu.  There is no barrier
// across an image: an MB waits on its own neighbours only.
//
// Inside a CTA the warps split an MB: warp 0 runs the I16 search and then
// the commit of its best mode (levels, with the trellis from m4); warp 1
// the I4 search; warp 2 (trellis only) the I4 trellis, a wavefront step
// behind warp 1, taking each step's modes as soon as warp 1 publishes
// them; warp 3 the UV search, the chroma DC error diffusion and the chroma
// levels.  The four depend on each other only at the I4-versus-I16
// compare, which runs after them on the running I4 scores that warp 1
// records per subblock.  In a warp the lanes split the work: I16 runs its
// 4 modes x 16 blocks as 64 (mode, block) pairs, two per lane, and its
// trellis block b on lane b under all three entry contexts, resolving the
// real ones in raster order; the I4 search and trellis run a subblock on
// each half-warp; in the search ten lanes predict the ten B modes and each
// candidate takes four lanes (four candidates a round), which hold the 4x4
// block by rows and, between a transform's two passes, by columns; the
// trellis's node terms are spread over 16 lanes; UV runs its 4 modes x 2
// planes x 4 blocks on the 32 lanes.  Ties between scores go to the lowest mode (or
// candidate rank), as in the JAX kernel's argmin.
//
// Segments: the CTA keeps its image's four parameter sets in shared memory
// and each MB reads the set of its segment id.  Trellis (a template branch,
// so the kTrellis = false kernel has no trellis code): the decision stays
// the non-trellis search's; only the chosen luma path is quantized again,
// and its reconstruction and the nnz of its final levels (a 16-bit mask,
// the entry contexts of the MBs below and to the right) follow the trellis.

#include "common.cuh"
#include "trellis.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;       // score of a disallowed mode

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

// Lane of the least value over the warp (or each `width`-lane segment of
// it), the lowest lane among equals.
__device__ __forceinline__ int warp_argmin(int v, int lane, int width = 32) {
    int idx = lane;
    for (int off = width >> 1; off > 0; off >>= 1) {
        const int ov = __shfl_xor_sync(kFull, v, off, width);
        const int oi = __shfl_xor_sync(kFull, idx, off, width);
        if (ov < v || (ov == v && oi < idx)) {
            v = ov;
            idx = oi;
        }
    }
    return idx;
}


enum { W_I16 = 0, W_I4 = 1, W_TRELLIS = 2, W_UV = 3, kWarps = 4 };
constexpr int kThreads = 32 * kWarps;
constexpr int kI4HeaderBudget = 256 * 16 * 16 / 4;  // the 64-bit/MB B-mode header budget

// The MB's neighbourhood, with VP8's frame borders: 127 above the frame
// (its corner included), 129 left of it.
struct Edges {
    uint8_t ty[21];         // luma: corner, 16 above, 4 above-right
    uint8_t ly[16];         // luma: the left column
    uint8_t tc[2][9];       // U, V: corner, 8 above
    uint8_t lc[2][8];       // U, V: the left columns
    uint8_t sy[256];        // the MB's source luma, row-major
    uint8_t sc[2][64];      // its source U, V
    int tb[4], lb[4];       // B-mode contexts: the above MB's bottom row, the left MB's right column
    int te[2][2], le[2][2]; // chroma DC errors from above and from the left, per plane
    unsigned top_nz, left_nz;  // nnz of the above MB's bottom row (bit x), the left MB's right column (bit y)
};

struct I16Ws {              // warp W_I16
    int y2[4][16];          // the 16 luma DCs per mode, then their reconstruction
    int16_t y2lv[4][16];    // Y2 levels per mode
    int16_t lv[256];        // the best mode's levels
    uint8_t rec[16][16];    // and its reconstruction
    int best, score;
    unsigned nz;            // nnz mask of lv from position 1 (trellis)
};

struct I4Ws {               // warps W_I4 and W_TRELLIS; [2]: per half-warp
    uint8_t ws[17][21];     // the search's bordered workspace: [tl | above | above-right], left, recon
    uint8_t wt[17][21];     // the trellis's
    int sse[2][10];         // prediction SSE per B mode
    uint8_t by_rank[2][10]; // the B modes in candidate order
    int16_t cl[2][4][16];   // each candidate's levels (zigzag), four-lane candidates
    int cz[2][16];          // the trellis's coefficients, then levels (zigzag)
    int sb_rate[16], sb_dist[16], sb_mc[16];  // the chosen mode's terms per subblock
    uint8_t sb_nz[16];      // whether the search's levels have a nonzero
    uint8_t nzt[16];        // whether the trellis's do
    int rate[16], disto[16], tmc[16];  // the running sums after each subblock, raster order
    uint8_t modes[16];
    int16_t lv[256];        // the search's levels
    int16_t lvt[256];       // the trellis's
    unsigned nz;            // nnz mask of lvt (bit i)
    int done;               // wavefront steps of the search done (W_I4 -> W_TRELLIS)
    long long terms[2][3][32];  // the trellis DP's node terms
};

struct UvWs {               // warp W_UV
    int cdc[2][4];          // DCs of the chosen mode for the error diffusion
    uint8_t rec[2][8][8];
};

struct Shared {
    Tables T;
    Edges E;
    I16Ws a;
    I4Ws b;
    UvWs c;
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

// DC of an n x n block from its edges (top[0] the corner): the rounded mean
// of the neighbours that exist, 128 at the frame's top-left MB.
__device__ int edge_dc(const uint8_t* top, const uint8_t* left, int n, int log2n, bool above,
                       bool has_left) {
    if (!above && !has_left) return 128;
    int total = 0;
    for (int i = 0; i < n; ++i) {
        if (above) total += top[1 + i];
        if (has_left) total += left[i];
    }
    const int shf = log2n - 1 + above + has_left;
    return (total + (1 << (shf - 1))) >> shf;
}

// Whole-block DC/V/H/TM prediction of pixel (r, c) from the block's edges.
__device__ __forceinline__ int edge_pred(int mode, const uint8_t* top, const uint8_t* left, int r,
                                         int c, int dc) {
    switch (mode) {
    case 0: return dc;
    case 1: return top[1 + c];
    case 2: return left[r];
    default: return clip255(left[r] + top[1 + c] - top[0]);
    }
}

struct Mb {
    int x, y;
    const int* P;  // the parameters of the MB's segment
};

__device__ __forceinline__ bool mode_allowed(int mode, const Mb& mb) {
    return mode == 0 || (mode == 1 && mb.y > 0) || (mode == 2 && mb.x > 0)
           || (mode == 3 && mb.y > 0 && mb.x > 0);
}

// I16 block (mode, blk): prediction and source pixels, row-major.
__device__ void i16_pred_src(const Edges& E, int mode, int blk, int dc, int* pred, int* src) {
    const int br = (blk >> 2) * 4, bc = (blk & 3) * 4;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int r = br + (k >> 2), c = bc + (k & 3);
        pred[k] = edge_pred(mode, E.ty, E.ly, r, c, dc);
        src[k] = E.sy[r * 16 + c];
    }
}

// The I16 search.  Leaves the Y2 levels of each mode in w.y2lv and each
// mode's reconstructed DCs in w.y2; returns the best mode and writes its
// score at lambda_mode to *score.
__device__ int i16_search(const Mb& mb, int lane, const Tables& T, const Edges& E, I16Ws& w,
                          int* score) {
    const int* P = mb.P;
    const int dc = edge_dc(E.ty, E.ly, 16, 4, mb.y > 0, mb.x > 0);
    const int blk = lane & 15;
    int pred[16], src[16], coef[16], lv[16];
    // Pass A: the DCs of the 64 (mode, block) pairs, for the Y2 WHT.
    for (int j = 0; j < 2; ++j) {
        const int mode = (lane >> 4) + 2 * j;
        i16_pred_src(E, mode, blk, dc, pred, src);
#pragma unroll
        for (int k = 0; k < 16; ++k) src[k] -= pred[k];
        fdct4x4(src, coef);
        w.y2[mode][blk] = coef[0];
    }
    __syncwarp();
    if (lane < 4) {
        int in[16], y2[16], rec[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) in[k] = w.y2[lane][k];
        fwht4x4(in, y2);
        quant_block(y2, P, P_Y2_IQ, P_Y2_BIAS, lv);
#pragma unroll
        for (int z = 0; z < 16; ++z) w.y2lv[lane][z] = static_cast<int16_t>(lv[z]);
        dequant_block(lv, P, P_Y2_Q, in);
        iwht4x4(in, rec);
#pragma unroll
        for (int k = 0; k < 16; ++k) w.y2[lane][k] = rec[k];
    }
    __syncwarp();
    // Pass B: AC levels, rate, reconstruction and distortion per pair;
    // sums over each half-warp's 16 blocks (lanes 0-15: modes 0 and 2,
    // lanes 16-31: modes 1 and 3).
    bool flat = true;
    const int v00 = E.sy[0];
    for (int k = lane; k < 256; k += 32) flat &= E.sy[k] == v00;
    flat = __all_sync(kFull, flat);
    int rate_m[4], dist_m[4], sc_m[4];
    for (int j = 0; j < 2; ++j) {
        const int mode = (lane >> 4) + 2 * j;
        int rec[16];
        i16_pred_src(E, mode, blk, dc, pred, src);
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
        coef[0] = w.y2[mode][blk];
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
            for (int z = 0; z < 16; ++z) y2lv[z] = w.y2lv[mode][z];
            int sd = spectral(P[P_TLAMBDA], td);
            if (flat && nz == 0) {
                d *= 2;
                sd *= 2;
            }
            m_rate = T.fixed_i16[mode] + residual_cost(y2lv, 1, 0, 0, T) + cost;
            m_dist = d + sd;
            m_score = mode_allowed(mode, mb) ? rd_score(m_rate, m_dist, P[P_LAMBDA_I16]) : kBig;
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

// The levels and reconstruction of I16 mode `best` into w.lv / w.rec.  With
// kTrellis, the 16 blocks' levels come from the trellis with the entry
// contexts of their top and left neighbours (across the MB edge from
// E.top_nz / E.left_nz); returns the nnz mask of the levels from position 1
// (bit 4y + x).
template <bool kTrellis>
__device__ unsigned i16_commit(const Mb& mb, int lane, int best, const Tables& T, const Edges& E,
                               I16Ws& w) {
    const int* P = mb.P;
    int pred[16], src[16], coef[16], lv[16];
    if (lane < 16) {
        const int dc = edge_dc(E.ty, E.ly, 16, 4, mb.y > 0, mb.x > 0);
        i16_pred_src(E, best, lane, dc, pred, src);
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
            const unsigned top = by == 0 ? E.top_nz >> bx : nz_mask >> (bi - 4);
            const unsigned left = bx == 0 ? E.left_nz >> by : nz_mask >> (bi - 1);
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
        for (int z = 0; z < 16; ++z) w.lv[lane * 16 + z] = static_cast<int16_t>(lv[z]);
        dequant_block(lv, P, P_Y1_Q, coef);
        coef[0] = w.y2[best][lane];
        idct4x4(coef);
        const int br = (lane >> 2) * 4, bc = (lane & 3) * 4;
#pragma unroll
        for (int k = 0; k < 16; ++k)
            w.rec[br + (k >> 2)][bc + (k & 3)] = static_cast<uint8_t>(clip255(pred[k] + coef[k]));
    }
    return nz_mask;
}

// A bordered I4 workspace: row 0 = [tl | 16 above | 4 above-right], column
// 0 = left; column-3 subblocks of rows 4/8/12 reuse the MB's above-right.
__device__ void i4_borders(const Edges& E, int lane, uint8_t (*ws)[21]) {
    if (lane < 21) {
        const uint8_t v = E.ty[lane];
        ws[0][lane] = v;
        if (lane >= 17) ws[4][lane] = ws[8][lane] = ws[12][lane] = v;
    }
    if (lane < 16) ws[1 + lane][0] = E.ly[lane];
}

// The 13 edge pixels of I4 subblock (R0 / 4, C0 / 4) from a workspace:
// left column bottom-up, the corner, the eight above.
__device__ __forceinline__ void i4_edges(const uint8_t (*ws)[21], int R0, int C0, int* e) {
    e[0] = ws[R0 + 4][C0];
    e[1] = ws[R0 + 3][C0];
    e[2] = ws[R0 + 2][C0];
    e[3] = ws[R0 + 1][C0];
#pragma unroll
    for (int k = 0; k < 9; ++k) e[4 + k] = ws[R0][C0 + k];
}

__device__ __forceinline__ void i4_src(const Edges& E, int R0, int C0, int* src) {
#pragma unroll
    for (int k = 0; k < 16; ++k) src[k] = E.sy[(R0 + (k >> 2)) * 16 + C0 + (k & 3)];
}

// The 16 I4 subblocks in their own wavefront t = x + 2y inside the MB: a
// subblock needs its left, top-left, top and top-right neighbours (those of
// column 3 take the MB's above-right), so 10 steps instead of 16, with two
// subblocks in each of steps 2-7.  Step s holds kSbOrder[s][0] and, when
// not -1, kSbOrder[s][1]; a half-warp takes each.
constexpr int kSbSteps = 10;
__constant__ int kSbOrder[kSbSteps][2] = {{0, -1}, {1, -1}, {2, 4}, {3, 5}, {6, 8},
                                          {7, 9}, {10, 12}, {11, 13}, {14, -1}, {15, -1}};

// ---- An I4 candidate on four lanes: lane j of the group holds row j (or,
// between the transforms' two passes, column j) of the 4x4 block. ----

// The zigzag position of raster coefficient p, a nibble of a constant.
__device__ __forceinline__ int zigzag_of(int p) {
    return static_cast<int>((0xFEA9DB83C7426510ULL >> (4 * p)) & 15);
}

__device__ __forceinline__ int pick4(const int* v, int k) {
    return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

// In-place 4x4 transpose over the aligned group of four lanes holding it
// (lane j's v[k] = M[j][k] becomes M[k][j]).
__device__ __forceinline__ void transpose4(int* v, int lane) {
    const int j = lane & 3, g = lane & ~3;
    int out[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int got = __shfl_sync(kFull, pick4(v, (j + k) & 3), g | ((j - k) & 3));
#pragma unroll
        for (int m = 0; m < 4; ++m) out[m] = m == ((j - k) & 3) ? got : out[m];
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) v[m] = out[m];
}

__device__ __forceinline__ int group_sum(int v) {
    v += __shfl_xor_sync(kFull, v, 1);
    return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ int group_max(int v) {
    v = max(v, __shfl_xor_sync(kFull, v, 1));
    return max(v, __shfl_xor_sync(kFull, v, 2));
}

struct Cand {
    int rec[4];                  // the reconstruction's row j
    int rates, dist, mc, score;  // the rate, distortion, mode cost and RD score
    bool has;                    // a nonzero level
};

// Candidate `mode` of I4 subblock (R0, C0) on the group of four lanes of
// `lane`: fdct, quantization, rate (the levels through cl, zigzag), dequant,
// idct, distortion and score, bit for bit as the JAX kernel's candidate.
// Every lane of the warp calls it.
__device__ Cand i4_candidate4(int mode, int lane, const int* P, const Tables& T, const Edges& E,
                              const int* e, int R0, int C0, int tb, int lb, int ctx0,
                              int16_t* cl) {
    const int j = lane & 3;
    int p[4], s[4], v[4];
    {
        int pred[16];
        predict_b4(mode, e, pred);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            p[k] = j == 0 ? pred[k] : j == 1 ? pred[4 + k] : j == 2 ? pred[8 + k] : pred[12 + k];
            s[k] = E.sy[(R0 + j) * 16 + C0 + k];
        }
    }
    {  // fdct4x4: the row pass on row j, then the column pass on column j
        const int e0 = s[0] - p[0], e1 = s[1] - p[1], e2 = s[2] - p[2], e3 = s[3] - p[3];
        const int a = (e0 + e3) * 8, b = (e1 + e2) * 8, c = (e1 - e2) * 8, d = (e0 - e3) * 8;
        v[0] = a + b;
        v[1] = (c * 2217 + d * 5352 + 14500) >> 12;
        v[2] = a - b;
        v[3] = (d * 2217 - c * 5352 + 7500) >> 12;
    }
    transpose4(v, lane);
    {
        const int c0 = v[0], c1 = v[1], c2 = v[2], c3 = v[3];
        const int a = c0 + c3, b = c1 + c2, c = c1 - c2, d = c0 - c3;
        v[0] = (a + b + 7) >> 4;
        v[1] = ((c * 2217 + d * 5352 + 12000) >> 16) + (d != 0);
        v[2] = (a - b + 7) >> 4;
        v[3] = (d * 2217 - c * 5352 + 51000) >> 16;
    }
    // v[i] is raster coefficient 4i + j.
    int lv[4], z[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        z[i] = zigzag_of(4 * i + j);
        lv[i] = quant(v[i], P[P_Y1_IQ + z[i]], P[P_Y1_BIAS + z[i]]);
        cl[z[i]] = static_cast<int16_t>(lv[i]);
    }
    __syncwarp();
    // The rate (residual_cost): lane j rates zigzag positions 4j .. 4j + 3,
    // each term an independent lookup, kept up to the block's last nonzero.
    const int base = 3 * 16 * 3;
    int last = -1, term[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int zz = 4 * j + q;
        const int a = abs(static_cast<int>(cl[zz]));
        if (a != 0) last = zz;
        const int ctx = zz == 0 ? ctx0 : min(abs(static_cast<int>(cl[zz - 1])), 2);
        term[q] = T.cls[((base + zz * 3 + ctx) * 11) + token_class(min(a, 67))] + T.fixed[min(a, 2047)];
    }
    last = group_max(last);
    int share = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) share += 4 * j + q <= last ? term[q] : 0;
    share = group_sum(share);  // every lane: the shuffles take the whole warp
    int cost;
    if (last < 0) {
        cost = T.eob[base + ctx0];
    } else {
        cost = (ctx0 == 0 ? T.init[base] : 0) + share;
        if (last < 15) cost += T.eob[base + (last + 1) * 3 + (abs(static_cast<int>(cl[last])) == 1 ? 1 : 2)];
    }
    Cand out;
    out.has = last >= 0;
    // Dequant, then idct4x4: the column pass on column j, the row pass on row j.
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = lv[i] * P[P_Y1_Q + z[i]];
    {
        const int r0 = v[0], r1 = v[1], r2 = v[2], r3 = v[3];
        const int a1 = r0 + r2, b1 = r0 - r2;
        const int c1 = mul16(r1, kC2) - (r3 + mul16(r3, kC1));
        const int d1 = (r1 + mul16(r1, kC1)) + mul16(r3, kC2);
        v[0] = a1 + d1;
        v[1] = b1 + c1;
        v[2] = b1 - c1;
        v[3] = a1 - d1;
    }
    transpose4(v, lane);
    {
        const int c0 = v[0], c1 = v[1], c2 = v[2], c3 = v[3];
        const int a1 = c0 + c2, b1 = c0 - c2;
        const int cc = mul16(c1, kC2) - (c3 + mul16(c3, kC1));
        const int dd = (c1 + mul16(c1, kC1)) + mul16(c3, kC2);
        v[0] = (a1 + dd + 4) >> 3;
        v[1] = (b1 + cc + 4) >> 3;
        v[2] = (b1 - cc + 4) >> 3;
        v[3] = (a1 - dd + 4) >> 3;
    }
    int d = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        out.rec[k] = clip255(p[k] + v[k]);
        d += (out.rec[k] - s[k]) * (out.rec[k] - s[k]);
    }
    d = group_sum(d);
    // t_transform(rec) - t_transform(src): the row pass on row j, the
    // column pass (weighted) on column j.
    int tr[4], ts[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        int* t = half ? ts : tr;
        const int* b = half ? s : out.rec;
        const int a0 = b[0] + b[2], a1 = b[1] + b[3], a2 = b[1] - b[3], a3 = b[0] - b[2];
        t[0] = a0 + a1;
        t[1] = a3 + a2;
        t[2] = a3 - a2;
        t[3] = a0 - a1;
        transpose4(t, lane);
    }
    int tdiff = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int* t = half ? ts : tr;
        const int a0 = t[0] + t[2], a1 = t[1] + t[3], a2 = t[1] - t[3], a3 = t[0] - t[2];
        const int sum = abs(a0 + a1) * T.weight_y[j] + abs(a3 + a2) * T.weight_y[4 + j]
                        + abs(a3 - a2) * T.weight_y[8 + j] + abs(a0 - a1) * T.weight_y[12 + j];
        tdiff += half ? -sum : sum;
    }
    const int td = abs(group_sum(tdiff)) >> 5;
    out.mc = T.fixed_i4[(tb * 10 + lb) * 10 + mode];
    out.rates = cost + out.mc;
    out.dist = d + spectral(P[P_TLAMBDA], td);
    out.score = rd_score(out.rates, out.dist, P[P_LAMBDA_I4]);
    return out;
}

// The I4 search over the 16 subblocks, a half-warp a subblock.  Leaves each
// subblock's mode and levels in w.modes / w.lv, the reconstruction in w.ws
// and the running (rate, distortion, mode cost) after each subblock in
// raster order in w.rate / w.disto / w.tmc, and publishes w.done = s + 1
// once the modes of wavefront step s are decided.
__device__ void i4_search(const Mb& mb, int lane, int n_try, const Tables& T, const Edges& E,
                          I4Ws& w) {
    const int* P = mb.P;
    const int h = lane >> 4, hl = lane & 15;
    i4_borders(E, lane, w.ws);
    __syncwarp();
    for (int s = 0; s < kSbSteps; ++s) {
        const int own = kSbOrder[s][h];
        const bool active = own >= 0;
        const int i = active ? own : kSbOrder[s][0];  // an idle half repeats the other's, unwritten
        const int sby = i >> 2, sbx = i & 3, R0 = sby * 4, C0 = sbx * 4;
        int e[13], src[16];
        i4_edges(w.ws, R0, C0, e);
        i4_src(E, R0, C0, src);
        int pred[16];
        if (hl < 10) {
            predict_b4(hl, e, pred);
            int sse = 0;
#pragma unroll
            for (int k = 0; k < 16; ++k) sse += (pred[k] - src[k]) * (pred[k] - src[k]);
            w.sse[h][hl] = sse;
        }
        __syncwarp();
        // Candidates in rank order: DC first (unless all ten are tried), then
        // the B modes of least SSE, ties to the lower mode.  Lane hl < 10
        // ranks mode hl.
        if (hl < 10) {
            const int mine = w.sse[h][hl];
            int rank = 0;
            if (n_try < 10 && hl == 0) {
                rank = 0;
            } else {
#pragma unroll
                for (int k = 0; k < 10; ++k) {
                    const int o = w.sse[h][k];
                    rank += (n_try < 10 && k == 0) || o < mine || (o == mine && k < hl);
                }
            }
            w.by_rank[h][rank] = static_cast<uint8_t>(hl);
        }
        __syncwarp();
        const int tb = sby > 0 ? w.modes[i - 4] : E.tb[sbx];
        const int lb = sbx > 0 ? w.modes[i - 1] : E.lb[sby];
        const int ctx0 = (sby > 0 ? w.sb_nz[i - 4] : 0) + (sbx > 0 ? w.sb_nz[i - 1] : 0);
        // Four lanes a candidate, four candidates a round; a round's best
        // replaces the kept one only when it scores lower, so ties go to
        // the lower rank.
        int best = 0x7fffffff;
#pragma unroll 1
        for (int r0 = 0; r0 < n_try; r0 += 4) {
            const int c = r0 + (hl >> 2);
            const int mode = c < n_try ? w.by_rank[h][c] : 0;
            int16_t* cl = w.cl[h][hl >> 2];
            const Cand cd = i4_candidate4(mode, lane, P, T, E, e, R0, C0, tb, lb, ctx0, cl);
            const int score = c < n_try ? cd.score : 0x7fffffff;
            const int k = warp_argmin(score, lane, 16);
            const int k_score = __shfl_sync(kFull, score, k);
            if (k_score < best && active && (lane & ~3) == k) {
                const int j = lane & 3;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    w.ws[R0 + 1 + j][C0 + 1 + q] = static_cast<uint8_t>(cd.rec[q]);
                    w.lv[i * 16 + 4 * j + q] = cl[4 * j + q];
                }
                if (j == 0) {
                    w.modes[i] = static_cast<uint8_t>(mode);
                    w.sb_rate[i] = cd.rates;
                    w.sb_dist[i] = cd.dist;
                    w.sb_mc[i] = cd.mc;
                    w.sb_nz[i] = static_cast<uint8_t>(cd.has);
                }
            }
            best = min(best, k_score);
            __syncwarp();
        }
        if (lane == 0) {
            __threadfence_block();
            *reinterpret_cast<volatile int*>(&w.done) = s + 1;
        }
    }
    if (lane == 0) {
        int rate = 211, disto = 0, tmc = 0;  // 211: the B-mode header's initial penalty
        for (int i = 0; i < 16; ++i) {
            rate += w.sb_rate[i];
            disto += w.sb_dist[i];
            tmc += w.sb_mc[i];
            w.rate[i] = rate;
            w.disto[i] = disto;
            w.tmc[i] = tmc;
        }
    }
}

// Whether I4 beats the I16 score: the running score stays below it, and the
// mode cost within the header budget, after every subblock.
__device__ bool i4_wins(const I4Ws& w, int i16_score, int lambda_mode) {
    bool ok = true;
    for (int i = 0; i < 16; ++i)
        ok = ok && rd_score(w.rate[i], w.disto[i], lambda_mode) < i16_score
             && w.tmc[i] <= kI4HeaderBudget;
    return ok;
}

// The I4 trellis: the 16 subblocks again with the modes the search chose,
// in the same wavefront, a step as soon as the search has published its
// modes; each is predicted from the trellis reconstruction in w.wt and
// trellis-quantized with the entry context of its top and left neighbours
// (across the MB edge from E.top_nz / E.left_nz).  A half-warp runs a
// subblock: its transforms on groups of four lanes (row j / column j, as
// i4_candidate4), its coefficients through w.cz to lane n = zigzag position
// n, which rates the DP's nodes of n (trellis_dp_half) and unwinds its
// level.  Leaves the levels in w.lvt and their nnz mask (bit i) in w.nz.
__device__ void i4_trellis(const Mb& mb, int lane, const Tables& T, const Edges& E, I4Ws& w) {
    const int* P = mb.P;
    const int h = lane >> 4, hl = lane & 15, j = lane & 3;
    int* cz = w.cz[h];
    i4_borders(E, lane, w.wt);
    const int thresh = (P[P_Y1_Q + 1] * P[P_Y1_Q + 1]) / 4;
    for (int s = 0; s < kSbSteps; ++s) {
        while (*reinterpret_cast<volatile int*>(&w.done) <= s) {
        }
        __threadfence_block();
        __syncwarp();
        const int own = kSbOrder[s][h];
        const bool active = own >= 0;
        const int i = active ? own : kSbOrder[s][0];
        const int sby = i >> 2, sbx = i & 3, R0 = sby * 4, C0 = sbx * 4;
        int e[13], p[4], v[4];
        i4_edges(w.wt, R0, C0, e);
        {
            int pred[16];
            predict_b4(w.modes[i], e, pred);
#pragma unroll
            for (int k = 0; k < 4; ++k)
                p[k] = j == 0 ? pred[k] : j == 1 ? pred[4 + k] : j == 2 ? pred[8 + k] : pred[12 + k];
        }
        {  // fdct4x4: the row pass on row j, then the column pass on column j
            const uint8_t* sr = E.sy + (R0 + j) * 16 + C0;
            const int e0 = sr[0] - p[0], e1 = sr[1] - p[1], e2 = sr[2] - p[2], e3 = sr[3] - p[3];
            const int a = (e0 + e3) * 8, b = (e1 + e2) * 8, c = (e1 - e2) * 8, d = (e0 - e3) * 8;
            v[0] = a + b;
            v[1] = (c * 2217 + d * 5352 + 14500) >> 12;
            v[2] = a - b;
            v[3] = (d * 2217 - c * 5352 + 7500) >> 12;
        }
        transpose4(v, lane);
        {
            const int c0 = v[0], c1 = v[1], c2 = v[2], c3 = v[3];
            const int a = c0 + c3, b = c1 + c2, c = c1 - c2, d = c0 - c3;
            v[0] = (a + b + 7) >> 4;
            v[1] = ((c * 2217 + d * 5352 + 12000) >> 16) + (d != 0);
            v[2] = (a - b + 7) >> 4;
            v[3] = (d * 2217 - c * 5352 + 51000) >> 16;
        }
        if (hl < 4) {  // v[r] is raster coefficient 4r + j
#pragma unroll
            for (int r = 0; r < 4; ++r) cz[zigzag_of(4 * r + j)] = v[r];
        }
        __syncwarp();
        // Lane hl: zigzag position n = hl (trellis_prepare, spread).
        const int c = cz[hl];
        const int an = abs(c) + P[P_Y1_SHARPEN + hl];
        const int ap = hl > 0 ? abs(cz[hl - 1]) + P[P_Y1_SHARPEN + hl - 1] : 0;
        const unsigned big = __ballot_sync(kFull, c * c > thresh) >> (lane & 16) & 0xFFFFu;
        const int last = min((big ? 31 - __clz(big) : -1) + 1, 15);
        const unsigned top = sby == 0 ? (E.top_nz >> sbx) & 1 : w.nzt[i - 4];
        const unsigned left = sbx == 0 ? (E.left_nz >> sby) & 1 : w.nzt[i - 1];
        const TrellisPath path = trellis_dp_half(
            an, ap, last, P + P_Y1_Q, P + P_Y1_IQ, P[P_LAMBDA_TRELLIS_I4], 0,
            static_cast<int>(top + left), T.cls + 3 * 16 * 3 * 11, T.eob + 3 * 16 * 3,
            T.init + 3 * 16 * 3, T.fixed, lane, w.terms[h]);
        const unsigned dbits = trellis_path_bits(path, 0);
        int lv = 0;
        if (hl <= path.best_n) {
            const int lvl = min((an * P[P_Y1_IQ + hl]) >> 17, 2047) + ((dbits >> hl) & 1);
            lv = c < 0 ? -lvl : lvl;
        }
        __syncwarp();  // cz is read: it takes the levels now
        cz[hl] = lv;
        if (active) {
            w.lvt[i * 16 + hl] = static_cast<int16_t>(lv);
            if (hl == 0) w.nzt[i] = static_cast<uint8_t>(path.best_n >= 0);
        }
        __syncwarp();
        // Dequant, idct4x4 (the column pass on column j, the row pass on row
        // j) and the reconstruction's row j.
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int z = zigzag_of(4 * r + j);
            v[r] = cz[z] * P[P_Y1_Q + z];
        }
        {
            const int r0 = v[0], r1 = v[1], r2 = v[2], r3 = v[3];
            const int a1 = r0 + r2, b1 = r0 - r2;
            const int c1 = mul16(r1, kC2) - (r3 + mul16(r3, kC1));
            const int d1 = (r1 + mul16(r1, kC1)) + mul16(r3, kC2);
            v[0] = a1 + d1;
            v[1] = b1 + c1;
            v[2] = b1 - c1;
            v[3] = a1 - d1;
        }
        transpose4(v, lane);
        {
            const int c0 = v[0], c1 = v[1], c2 = v[2], c3 = v[3];
            const int a1 = c0 + c2, b1 = c0 - c2;
            const int cc = mul16(c1, kC2) - (c3 + mul16(c3, kC1));
            const int dd = (c1 + mul16(c1, kC1)) + mul16(c3, kC2);
            v[0] = (a1 + dd + 4) >> 3;
            v[1] = (b1 + cc + 4) >> 3;
            v[2] = (b1 - cc + 4) >> 3;
            v[3] = (a1 - dd + 4) >> 3;
        }
        if (active && hl < 4) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                w.wt[R0 + 1 + j][C0 + 1 + k] = static_cast<uint8_t>(clip255(p[k] + v[k]));
        }
        __syncwarp();
    }
    if (lane == 0) {
        unsigned nz = 0;
        for (int i = 0; i < 16; ++i) nz |= static_cast<unsigned>(w.nzt[i]) << i;
        w.nz = nz;
    }
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

// UV search, chroma DC diffusion and the chosen mode's levels (to uvlv)
// and reconstruction (to w.rec).  Lane = mode * 8 + plane * 4 + block.
// Writes the errors the MB below diffuses to top_err[plane * 2 + k] and
// leaves those of the MB to the right in E.le.  Returns the mode.
__device__ int uv_search(const Mb& mb, int lane, const Tables& T, Edges& E, UvWs& w,
                         int* top_err, int16_t* uvlv) {
    const int* P = mb.P;
    const int mode = lane >> 3, ch = (lane >> 2) & 1, blk = lane & 3;
    const int br = (blk >> 1) * 4, bc = (blk & 1) * 4;
    const uint8_t* top = E.tc[ch];
    const uint8_t* left = E.lc[ch];
    const int dc = edge_dc(top, left, 8, 3, mb.y > 0, mb.x > 0);
    int pred[16], src[16], coef[16], lv[16], rec[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int r = br + (k >> 2), c = bc + (k & 3);
        pred[k] = edge_pred(mode, top, left, r, c, dc);
        src[k] = E.sc[ch][r * 8 + c];
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
        score = mode_allowed(mode, mb) ? rd_score(rate, d, P[P_LAMBDA_UV]) : kBig;
    }
    const int best = warp_argmin(score, lane) >> 3;

    // Chroma DC error diffusion (C1 = 7, C2 = 8) over the chosen mode's
    // blocks: QuantizeSingle replaces each DC by its reconstruction.
    if (mode == best) w.cdc[ch][blk] = coef[0];
    __syncwarp();
    if (lane < 2) {
        const int q = P[P_UV_Q], iq = P[P_UV_IQ], bias = P[P_UV_BIAS];
        int* dcs = w.cdc[lane];
        const int e0 = diffuse_dc(dcs[0], E.te[lane][0], E.le[lane][0], q, iq, bias);
        const int e1 = diffuse_dc(dcs[1], E.te[lane][1], e0, q, iq, bias);
        const int e2 = diffuse_dc(dcs[2], e0, E.le[lane][1], q, iq, bias);
        const int e3 = diffuse_dc(dcs[3], e1, e2, q, iq, bias);
        const int nl1 = (3 * e3) >> 2;
        top_err[lane * 2] = e2;
        top_err[lane * 2 + 1] = e3 - nl1;
        E.le[lane][0] = e1;
        E.le[lane][1] = nl1;
    }
    __syncwarp();
    if (mode == best) {
        coef[0] = w.cdc[ch][blk];
        quant_block(coef, P, P_UV_IQ, P_UV_BIAS, lv);
#pragma unroll
        for (int z = 0; z < 16; ++z) uvlv[(ch * 4 + blk) * 16 + z] = static_cast<int16_t>(lv[z]);
        dequant_block(lv, P, P_UV_Q, res);
        idct4x4(res);
#pragma unroll
        for (int k = 0; k < 16; ++k)
            w.rec[ch][br + (k >> 2)][bc + (k & 3)] = static_cast<uint8_t>(clip255(pred[k] + res[k]));
    }
    return best;
}

// Row r of image b: edge[b][r] holds the bottom pixel row of its MBs
// (luma W, then U and V W/2 each); prog[b * mbh + r] counts its finished
// MBs; prog[batch * mbh] is the row ticket.
// Two CTAs an SM leave ptxas 255 registers a thread, so it need not spill.
template <bool kTrellis>
__global__ void __launch_bounds__(kThreads, 2) enc_kernel(
    const uint8_t* __restrict__ y, long long y_bs, const uint8_t* __restrict__ u, long long u_bs,
    const uint8_t* __restrict__ v, long long v_bs, const int* __restrict__ params,
    long long params_bs, const uint8_t* __restrict__ sid, long long sid_bs,
    const int* __restrict__ consts, const int* __restrict__ cls, long long cls_bs,
    const int* __restrict__ eob, long long eob_bs, const int* __restrict__ init, long long init_bs,
    int mbw, int mbh, int batch, int n_try, uint8_t* lmode, uint8_t* cmode, uint8_t* bpred,
    int16_t* ylv, int16_t* y2lv, int16_t* uvlv, uint8_t* edge, int* errs, int* nnz, int* prog) {
    __shared__ Shared S;
    Tables& T = S.T;
    Edges& E = S.E;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    if (tid == 0) S.row = atomicAdd(prog + static_cast<long long>(batch) * mbh, 1);
    __syncthreads();
    const int b = S.row % batch, r = S.row / batch;
    for (int k = tid; k < kSegments * P_COUNT; k += kThreads)
        (&T.params[0][0])[k] = params[b * params_bs + k];
    for (int k = tid; k < 2048; k += kThreads) T.fixed[k] = consts[C_FIXED + k];
    for (int k = tid; k < 1000; k += kThreads) T.fixed_i4[k] = consts[C_FIXED_I4 + k];
    if (tid < 4) {
        T.fixed_i16[tid] = consts[C_FIXED_I16 + tid];
        T.fixed_uv[tid] = consts[C_FIXED_UV + tid];
    }
    if (tid < 16) T.weight_y[tid] = consts[C_WEIGHT_Y + tid];
    for (int k = tid; k < kClsCount; k += kThreads) T.cls[k] = cls[b * cls_bs + k];
    for (int k = tid; k < kEobCount; k += kThreads) {
        T.eob[k] = eob[b * eob_bs + k];
        T.init[k] = init[b * init_bs + k];
    }
    // The left edges of the row's first MB.
    if (tid < 16) E.ly[tid] = 129;
    if (tid < 16) E.lc[tid >> 3][tid & 7] = 129;
    if (tid < 4) {
        E.lb[tid] = 0;
        E.le[tid >> 1][tid & 1] = 0;
    }
    if (tid == 0) E.left_nz = 0;

    const int nmb = mbw * mbh;
    const int W = mbw * 16, CW = mbw * 8;
    const long long img = static_cast<long long>(b) * nmb;
    const long long erow = 2LL * W;  // bytes of an edge row
    const uint8_t* above = edge + (static_cast<long long>(b) * mbh + r - 1) * erow;  // r > 0
    uint8_t* mine = edge + (static_cast<long long>(b) * mbh + r) * erow;
    const uint8_t* sy = y + b * y_bs;
    const uint8_t* su = u + b * u_bs;
    const uint8_t* sv = v + b * v_bs;
    int* done_above = prog + static_cast<long long>(b) * mbh + r - 1;
    for (int x = 0; x < mbw; ++x) {
        if (tid == 0 && r > 0) {
            const int need = min(x + 2, mbw);
            while (ld_acquire(done_above) < need) __nanosleep(32);
        }
        __syncthreads();
        const int m = r * mbw + x;
        const long long mg = img + m;
        const int x0 = x * 16, cx0 = x * 8;
        // The edges from the row above (through L2) and the source MB.
        if (tid < 21) {
            int val = 127;
            if (r > 0) {
                if (tid == 0) val = x == 0 ? 129 : __ldcg(above + x0 - 1);
                else if (tid <= 16) val = __ldcg(above + x0 + tid - 1);
                else val = __ldcg(above + (x == mbw - 1 ? x0 + 15 : x0 + tid - 1));
            }
            E.ty[tid] = static_cast<uint8_t>(val);
        } else if (tid >= 32 && tid < 50) {
            const int p = (tid - 32) / 9, k = (tid - 32) % 9;
            int val = 127;
            if (r > 0) {
                const uint8_t* ac = above + W + p * (W / 2);
                val = k == 0 ? (x == 0 ? 129 : __ldcg(ac + cx0 - 1)) : __ldcg(ac + cx0 + k - 1);
            }
            E.tc[p][k] = static_cast<uint8_t>(val);
        } else if (tid >= 64 && tid < 68) {
            E.tb[tid - 64] = r > 0 ? __ldcg(bpred + (mg - mbw) * 16 + 12 + tid - 64) : 0;
        } else if (tid >= 68 && tid < 72) {
            const int p = (tid - 68) >> 1, k = (tid - 68) & 1;
            E.te[p][k] = r > 0 ? __ldcg(errs + (mg - mbw) * 4 + p * 2 + k) : 0;
        } else if (tid == 72) {
            E.top_nz = kTrellis && r > 0 ? (static_cast<unsigned>(__ldcg(nnz + mg - mbw)) >> 12) & 15 : 0;
            S.b.done = 0;
        }
        for (int k = tid; k < 256; k += kThreads) E.sy[k] = sy[(r * 16 + (k >> 4)) * W + x0 + (k & 15)];
        E.sc[tid >> 6][tid & 63] = (tid < 64 ? su : sv)[(r * 8 + ((tid & 63) >> 3)) * CW + cx0 + (tid & 7)];
        __syncthreads();

        Mb mb;
        mb.x = x;
        mb.y = r;
        mb.P = T.params[sid ? sid[b * sid_bs + m] & 3 : 0];
        if (warp == W_I16) {
            int score;
            const int best = i16_search(mb, lane, T, E, S.a, &score);
            const unsigned nz = i16_commit<kTrellis>(mb, lane, best, T, E, S.a);
            if (lane == 0) {
                S.a.best = best;
                S.a.score = score;
                S.a.nz = nz;
            }
        } else if (warp == W_I4) {
            if (n_try > 0) i4_search(mb, lane, n_try, T, E, S.b);
        } else if (warp == W_TRELLIS) {
            if (kTrellis && n_try > 0) i4_trellis(mb, lane, T, E, S.b);
        } else {
            const int uv = uv_search(mb, lane, T, E, S.c, errs + mg * 4, uvlv + mg * 128);
            if (lane == 0) cmode[mg] = static_cast<uint8_t>(uv);
        }
        __syncthreads();

        // The decision, the luma outputs, the edges for the row below and
        // the MB to the right.
        const bool use_i4 = n_try > 0 && i4_wins(S.b, S.a.score, mb.P[P_LAMBDA_MODE]);
        const int best = S.a.best;
        const uint8_t(*rec4)[21] = kTrellis ? S.b.wt : S.b.ws;
        for (int k = tid; k < 256; k += kThreads)
            ylv[mg * 256 + k] = use_i4 ? (kTrellis ? S.b.lvt[k] : S.b.lv[k]) : S.a.lv[k];
        if (tid < 16) {
            y2lv[mg * 16 + tid] = use_i4 ? 0 : S.a.y2lv[best][tid];
            bpred[mg * 16 + tid] = use_i4 ? S.b.modes[tid] : tid >= 12 ? kBmodeOfI16[best] : 0;
            const uint8_t bottom = use_i4 ? rec4[16][1 + tid] : S.a.rec[15][tid];
            const uint8_t right = use_i4 ? rec4[1 + tid][16] : S.a.rec[tid][15];
            mine[x0 + tid] = bottom;
            E.ly[tid] = right;
        } else if (tid < 32) {
            const int p = (tid - 16) >> 3, k = (tid - 16) & 7;
            mine[W + p * (W / 2) + cx0 + k] = S.c.rec[p][7][k];
            E.lc[p][k] = S.c.rec[p][k][7];
        } else if (tid < 36) {
            const int k = tid - 32;
            E.lb[k] = use_i4 ? S.b.modes[4 * k + 3] : kBmodeOfI16[best];
        } else if (tid == 36) {
            lmode[mg] = static_cast<uint8_t>(use_i4 ? 4 : best);
            if (kTrellis) {
                const unsigned l = use_i4 ? S.b.nz : S.a.nz;
                nnz[mg] = static_cast<int>(l);
                E.left_nz = ((l >> 3) & 1) | ((l >> 6) & 2) | ((l >> 9) & 4) | ((l >> 12) & 8);
            }
        }
        __syncthreads();
        if (tid == 0) {
            __threadfence();
            st_release(prog + static_cast<long long>(b) * mbh + r, x + 1);
        }
    }
}

}  // namespace

WEBP_API int webp_enc(const void* y, long long y_bs, const void* u, long long u_bs, const void* v,
                      long long v_bs, const void* params, long long params_bs, const void* sid,
                      long long sid_bs, const void* consts, const void* cls, long long cls_bs,
                      const void* eob, long long eob_bs, const void* init, long long init_bs,
                      int mbw, int mbh, int batch, int n_try, int do_trellis, void* lmode,
                      void* cmode, void* bpred, void* ylv, void* y2lv, void* uvlv, void* edge,
                      void* errs, void* nnz, void* prog, void* stream) {
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    auto kernel = do_trellis ? enc_kernel<true> : enc_kernel<false>;
    kernel<<<batch * mbh, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), y_bs, static_cast<const uint8_t*>(u), u_bs,
        static_cast<const uint8_t*>(v), v_bs, static_cast<const int*>(params), params_bs,
        static_cast<const uint8_t*>(sid), sid_bs, static_cast<const int*>(consts),
        static_cast<const int*>(cls), cls_bs, static_cast<const int*>(eob), eob_bs,
        static_cast<const int*>(init), init_bs, mbw, mbh, batch, n_try,
        static_cast<uint8_t*>(lmode), static_cast<uint8_t*>(cmode), static_cast<uint8_t*>(bpred),
        static_cast<int16_t*>(ylv), static_cast<int16_t*>(y2lv), static_cast<int16_t*>(uvlv),
        static_cast<uint8_t*>(edge), static_cast<int*>(errs), static_cast<int*>(nnz),
        static_cast<int*>(prog));
    return static_cast<int>(cudaGetLastError());
}

// Row CTAs of K5 the card keeps resident at once (the occupancy API over
// all SMs of the current device); -1 on an error.
WEBP_API int webp_enc_resident(int do_trellis) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return -1;
    const cudaError_t err = do_trellis
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, enc_kernel<true>, kThreads, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, enc_kernel<false>, kThreads, 0);
    return err == cudaSuccess ? per_sm * sms : -1;
}
