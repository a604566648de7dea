// The device token coder: kernels K13 (coefficient partitions), K14 (MB
// headers) and K15 (the lane coder alone), each lane one thread running the
// boolean coder of `boolenc.cuh`.
//
// K13 replaces webp_tpu/ops/token_ops.py:228 encode_coeff_partitions (with
// block_ops :80 and compute_contexts_dev :169) and the coder it calls,
// webp_tpu/ops/boolenc2.py:89 bool_encode_lanes.  The JAX form lays out 311
// (prob, bit, valid) op slots per block, 12 M per image at 768x512, and
// codes them all; here one lane per (image, partition) walks its MB rows
// (r % P == p, raster order) and codes each op where it is generated: tree
// path, extra bits, sign, then the EOB, under the image's 1,056
// probabilities in shared memory, with the block contexts of K6
// (`contexts.cuh`).  No op buffer exists.
// K14 replaces webp_tpu/ops/token_ops.py:424 encode_mb_headers (with
// header_ops :340): one lane per image continues its frame-header coder
// state with every MB header.
// K15 replaces bool_encode_lanes as a kernel of its own: one lane per
// stream of given [T, L] (bit, prob, valid) streams.
//
// Bound.  The bytes: K13 reads each MB's 400 int16 levels once (9.8 MB for
// 8 images at 768x512, 2.9 us at 3.35 TB/s), plus the neighbour blocks of
// its contexts (cached); the operations are a few per coded op.  Neither
// is what limits it: each lane is one dependent chain of coder steps (a
// split, up to 7 doublings, a byte store, carries that read back), so the
// time is the longest lane's op count times a step's latency.  Each lane
// is a warp of its own (B * P = 64 at the flagship, one an SM): lanes in
// one warp diverge and run in turn (4-7x slower, measured).  Spreading a
// lane's op generation over its warp is later work.

#include "boolenc.cuh"
#include "common.cuh"
#include "contexts.cuh"

namespace {

// ---- token tables (ops/token_ops.py TOKEN_CONSTS_NP) ----
constexpr int kTpMax = 7;  // the longest token-tree path
constexpr int kTokLen = 0;                       // [2][12]: start 0 / start 2 (no EOB branch)
constexpr int kTokBit = kTokLen + 2 * 12;        // [2][12][kTpMax]
constexpr int kTokNode = kTokBit + 2 * 12 * kTpMax;
constexpr int kCatNbits = kTokNode + 2 * 12 * kTpMax;  // [12] extra bits of a token class
constexpr int kCatProbs = kCatNbits + 12;        // [12][11]
constexpr int kCatBase = kCatProbs + 12 * 11;    // [12]
constexpr int kBandsOff = kCatBase + 12;         // [16]
constexpr int kTokConsts = kBandsOff + 16;

constexpr int kProbs = 4 * 8 * 3 * 11;  // an image's token probabilities
// Every lane is one warp's thread 0 (the warp loads the block's tables):
// lanes sharing a warp would diverge, and the warp would run them in turn.
constexpr int kWarp = 32;

// ---- MB-header tables (ops/token_ops.py HEADER_CONSTS_NP): per tree,
// path lengths [nsym], bits and nodes [nsym][max]; then probabilities ----
constexpr int tree_size(int nsym, int max) { return nsym * (1 + 2 * max); }
constexpr int kSegOff = 0;                             // 4 segment ids, paths <= 2
constexpr int kYmOff = kSegOff + tree_size(4, 2);      // 5 luma modes, <= 3
constexpr int kYmProbs = kYmOff + tree_size(5, 3);     // [4]
constexpr int kUvOff = kYmProbs + 4;                   // 4 chroma modes, <= 3
constexpr int kUvProbs = kUvOff + tree_size(4, 3);     // [3]
constexpr int kBpOff = kUvProbs + 3;                   // 10 B modes, <= 7
constexpr int kBpProbs = kBpOff + tree_size(10, 7);    // [10 above][10 left][9]
constexpr int kImplied = kBpProbs + 10 * 10 * 9;       // [5]: a whole-MB mode's B context
constexpr int kHdrConsts = kImplied + 5;

// Codes symbol `sym`'s path in the tree at `Off` of the header tables
// `tab`, node k's probability probs[node].
template <int Off, int NSym, int Max, typename P>
__device__ __forceinline__ void put_path(LaneCoder& c, const int* tab, int sym, const P* probs) {
    constexpr int kBit = Off + NSym, kNode = kBit + NSym * Max;
    const int len = tab[Off + sym];
    for (int k = 0; k < len; ++k) {
        c.put(tab[kBit + sym * Max + k], probs[tab[kNode + sym * Max + k]]);
    }
}

// Token-tree path of class `cls` from start s2 (1: after a zero, no EOB
// branch) under one (plane, band, context)'s 11 probabilities.
__device__ __forceinline__ void put_token(LaneCoder& c, const int* tab, int s2, int cls,
                                          const uint8_t* p) {
    const int row = s2 * 12 + cls;
    const int len = tab[kTokLen + row];
    for (int k = 0; k < len; ++k) {
        c.put(tab[kTokBit + row * kTpMax + k], p[tab[kTokNode + row * kTpMax + k]]);
    }
}

__device__ __forceinline__ void load_block(const int16_t* blk, int* lv) {
    const int4* q = reinterpret_cast<const int4*>(blk);
    const int4 a = q[0], b = q[1];
    const int w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        lv[2 * k] = static_cast<int16_t>(w[k] & 0xFFFF);
        lv[2 * k + 1] = w[k] >> 16;
    }
}

__device__ __forceinline__ bool all_zero(const int16_t* p, int n) {  // n: a multiple of 8
    const int4* q = reinterpret_cast<const int4*>(p);
    int any = 0;
    for (int k = 0; k < n / 8; ++k) {
        const int4 v = q[k];
        any |= v.x | v.y | v.z | v.w;
    }
    return any == 0;
}

// One zigzag block coded from position `first` with initial context `ctx`
// (webp_tpu/encode/vp8.py _write_block, token_ops.py block_ops).  The end
// is one past the last nonzero of all 16 positions: a Y block with a Y2
// block ignores its DC in its tokens and contexts, not in `end`.
__device__ void code_block(LaneCoder& c, const int* tab, const uint8_t* plane_probs,
                           const int16_t* blk, int first, int ctx) {
    int lv[16];
    load_block(blk, lv);
    int end = 0;
    for (int k = 15; k >= 0; --k) {
        if (lv[k] != 0) {
            end = k + 1;
            break;
        }
    }
    const int* bands = tab + kBandsOff;
    int ci = ctx, s2 = 0;
    for (int n = first; n < end; ++n) {
        const int level = lv[n];
        const int v = abs(level);
        const uint8_t* p = plane_probs + (bands[n] * 3 + ci) * 11;
        const int cls = v <= 4 ? v + 1
                               : 6 + (v >= 7) + (v >= 11) + (v >= 19) + (v >= 35) + (v >= 67);
        put_token(c, tab, s2, cls, p);
        if (cls >= 6) {
            const int nb = tab[kCatNbits + cls];
            const int extra = v - tab[kCatBase + cls];
            for (int k = 0; k < nb; ++k) {
                c.put((extra >> (nb - 1 - k)) & 1, tab[kCatProbs + cls * 11 + k]);
            }
        }
        if (cls != 1) c.put(level < 0, 128);
        s2 = v == 0;
        ci = min(v, 2);
    }
    if (end < 16) {
        const int pos = min(max(first, end), 15);
        const int eob_ctx = end > first ? (abs(lv[end - 1]) == 1 ? 1 : 2) : ctx;
        put_token(c, tab, 0, 0, plane_probs + (bands[pos] * 3 + eob_ctx) * 11);
    }
}

__global__ void __launch_bounds__(kWarp) coeff_tokens_kernel(
    const uint8_t* __restrict__ lmode, long long lm_bs, const int16_t* __restrict__ y2,
    const int16_t* __restrict__ y, const int16_t* __restrict__ uv,
    const uint8_t* __restrict__ probs, const int* __restrict__ consts, int mbw, int mbh,
    int nparts, int cap, uint8_t* __restrict__ data, long long* __restrict__ info) {
    __shared__ uint8_t sp[kProbs];
    __shared__ int tab[kTokConsts];
    const int b = blockIdx.x / nparts, p = blockIdx.x % nparts;
    for (int k = threadIdx.x; k < kProbs; k += kWarp) sp[k] = probs[b * kProbs + k];
    for (int k = threadIdx.x; k < kTokConsts; k += kWarp) tab[k] = consts[k];
    __syncthreads();
    if (threadIdx.x != 0) return;

    const int nmb = mbw * mbh;
    const long long img = static_cast<long long>(b) * nmb;
    const Levels L{lmode + b * lm_bs, y2 + img * 16, y + img * 256, uv + img * 128};
    const long long lane = static_cast<long long>(b) * nparts + p;
    LaneCoder c;
    c.init(0, 255, 24, data + lane * cap, cap);
    for (int my = p; my < mbh; my += nparts) {
        for (int mx = 0; mx < mbw; ++mx) {
            const int m = my * mbw + mx;
            if (all_zero(L.y2 + m * 16, 16) && all_zero(L.y + m * 256, 256)
                && all_zero(L.uv + m * 128, 128)) {
                continue;  // skipped: the MB header's flag says so
            }
            const bool has_y2 = L.lmode[m] != 4;
            if (has_y2) {
                code_block(c, tab, sp + 1 * 264, L.y2 + m * 16, 0, y2_ctx(L, m, mx, my, mbw));
            }
            const uint8_t* yp = sp + (has_y2 ? 0 : 3) * 264;
            for (int s = 0; s < 16; ++s) {
                code_block(c, tab, yp, L.y + (m * 16 + s) * 16, has_y2 ? 1 : 0,
                           y_ctx(L, m, s, mx, my, mbw));
            }
            for (int s = 0; s < 8; ++s) {
                code_block(c, tab, sp + 2 * 264, L.uv + (m * 8 + s) * 16, 0,
                           uv_ctx(L, m, s, mx, my, mbw));
            }
        }
    }
    c.finish(info + lane * 6);
}

__global__ void __launch_bounds__(kWarp) mb_headers_kernel(
    const uint8_t* __restrict__ lmode, long long lm_bs, const uint8_t* __restrict__ bpred,
    long long bp_bs, const uint8_t* __restrict__ cmode, long long cm_bs,
    const uint8_t* __restrict__ sid, long long sid_bs, const uint8_t* __restrict__ skipped,
    long long sk_bs, const long long* __restrict__ params, const int* __restrict__ consts,
    int mbw, int mbh, int cap, uint8_t* __restrict__ data, long long* __restrict__ info) {
    __shared__ int tab[kHdrConsts];
    for (int k = threadIdx.x; k < kHdrConsts; k += kWarp) tab[k] = consts[k];
    __syncthreads();
    const int b = blockIdx.x;
    if (threadIdx.x != 0) return;

    // params [8]: write_segments, the 3 segment-tree probabilities,
    // skip_prob, the frame header's (bottom, range, bit_num).
    const long long* pr = params + b * 8;
    const bool write_segments = pr[0] != 0;
    const int seg_probs[3] = {static_cast<int>(pr[1]), static_cast<int>(pr[2]),
                              static_cast<int>(pr[3])};
    const int skip_prob = static_cast<int>(pr[4]);
    const uint8_t *lm = lmode + b * lm_bs, *bp = bpred + b * bp_bs, *cm = cmode + b * cm_bs;
    LaneCoder c;
    c.init(static_cast<uint32_t>(pr[5]), static_cast<int>(pr[6]), static_cast<int>(pr[7]),
           data + static_cast<long long>(b) * cap, cap);
    // The B-mode context of sub-block k of MB n: its own B mode, or the one
    // its whole-MB luma mode implies.
    auto eff = [&](int n, int k) { return lm[n] == 4 ? bp[n * 16 + k] : tab[kImplied + lm[n]]; };
    for (int m = 0; m < mbw * mbh; ++m) {
        const int mx = m % mbw, my = m / mbw;
        if (write_segments) put_path<kSegOff, 4, 2>(c, tab, sid[b * sid_bs + m], seg_probs);
        c.put(skipped[b * sk_bs + m], skip_prob);
        put_path<kYmOff, 5, 3>(c, tab, lm[m], tab + kYmProbs);
        if (lm[m] == 4) {
            for (int s = 0; s < 16; ++s) {
                const int sy = s >> 2, sx = s & 3;
                const int top = sy > 0 ? bp[m * 16 + s - 4]
                                       : (my > 0 ? eff(m - mbw, 12 + sx) : 0);
                const int left = sx > 0 ? bp[m * 16 + s - 1]
                                        : (mx > 0 ? eff(m - 1, 4 * sy + 3) : 0);
                put_path<kBpOff, 10, 7>(c, tab, bp[m * 16 + s],
                                        tab + kBpProbs + (top * 10 + left) * 9);
            }
        }
        put_path<kUvOff, 4, 3>(c, tab, cm[m], tab + kUvProbs);
    }
    c.finish(info + b * 6);
}

__global__ void __launch_bounds__(kWarp) bool_lanes_kernel(
    const uint8_t* __restrict__ bits, const uint8_t* __restrict__ probs,
    const uint8_t* __restrict__ valid, int steps, int lanes,
    const long long* __restrict__ state, int cap, uint8_t* __restrict__ data,
    long long* __restrict__ info) {
    const int l = blockIdx.x;
    if (threadIdx.x != 0) return;
    LaneCoder c;
    c.init(static_cast<uint32_t>(state[l * 3]), static_cast<int>(state[l * 3 + 1]),
           static_cast<int>(state[l * 3 + 2]), data + static_cast<long long>(l) * cap, cap);
    for (long long t = 0; t < steps; ++t) {
        const long long i = t * lanes + l;
        if (valid[i]) c.put(bits[i], probs[i]);
    }
    c.finish(info + static_cast<long long>(l) * 6);
}

}  // namespace

// levels int16 dense [B][nmb][...], probs uint8 [B][1056], consts int32
// [n_consts]; data uint8 [B][nparts][cap] zero-filled, info int64
// [B][nparts][6] out.
WEBP_API int webp_coeff_tokens(const void* lmode, long long lm_bs, const void* y2, const void* y,
                               const void* uv, const void* probs, const void* consts,
                               int n_consts, int mbw, int mbh, int batch, int nparts, int cap,
                               void* data, void* info, void* stream) {
    if (n_consts != kTokConsts || nparts < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    coeff_tokens_kernel<<<batch * nparts, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(lmode), lm_bs, static_cast<const int16_t*>(y2),
        static_cast<const int16_t*>(y), static_cast<const int16_t*>(uv),
        static_cast<const uint8_t*>(probs), static_cast<const int*>(consts), mbw, mbh, nparts,
        cap, static_cast<uint8_t*>(data), static_cast<long long*>(info));
    return static_cast<int>(cudaGetLastError());
}

// Per-MB uint8 fields with batch strides (bpred [B][nmb][16]); params int64
// [B][8]; data uint8 [B][cap] zero-filled, info int64 [B][6] out.
WEBP_API int webp_mb_headers(const void* lmode, long long lm_bs, const void* bpred,
                             long long bp_bs, const void* cmode, long long cm_bs, const void* sid,
                             long long sid_bs, const void* skipped, long long sk_bs,
                             const void* params, const void* consts, int n_consts, int mbw,
                             int mbh, int batch, int cap, void* data, void* info, void* stream) {
    if (n_consts != kHdrConsts) return static_cast<int>(cudaErrorInvalidValue);
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    mb_headers_kernel<<<batch, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(lmode), lm_bs, static_cast<const uint8_t*>(bpred), bp_bs,
        static_cast<const uint8_t*>(cmode), cm_bs, static_cast<const uint8_t*>(sid), sid_bs,
        static_cast<const uint8_t*>(skipped), sk_bs, static_cast<const long long*>(params),
        static_cast<const int*>(consts), mbw, mbh, cap, static_cast<uint8_t*>(data),
        static_cast<long long*>(info));
    return static_cast<int>(cudaGetLastError());
}

// bits, probs, valid uint8 [steps][lanes]; state int64 [lanes][3] (bottom,
// range, bit_num); data uint8 [lanes][cap] zero-filled, info int64
// [lanes][6] out.
WEBP_API int webp_bool_lanes(const void* bits, const void* probs, const void* valid, int steps,
                             int lanes, const void* state, int cap, void* data, void* info,
                             void* stream) {
    if (lanes <= 0) return 0;
    bool_lanes_kernel<<<lanes, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bits), static_cast<const uint8_t*>(probs),
        static_cast<const uint8_t*>(valid), steps, lanes, static_cast<const long long*>(state),
        cap, static_cast<uint8_t*>(data), static_cast<long long*>(info));
    return static_cast<int>(cudaGetLastError());
}
