// The device token coder: kernels K13 (coefficient partitions), K14 (MB
// headers) and K15 (the lane coder alone), on the boolean coder of
// `boolenc.cuh`.
//
// K13 replaces webp_tpu/ops/token_ops.py:228 encode_coeff_partitions (with
// block_ops :80 and compute_contexts_dev :169) and the coder it calls,
// webp_tpu/ops/boolenc2.py:89 bool_encode_lanes.  The JAX form lays out 311
// (prob, bit, valid) op slots per block, 12 M per image at 768x512, and
// codes them all.  Here one CTA per (image, partition) lane codes the MB
// rows r with r % P == p in raster order: three producer warps generate
// the ops and one coder warp codes them.
// - A producer warp takes the lane's MBs k = w, w + 3, ... and gives one of
//   the MB's 25 blocks to each lane (Y2, 16 Y, 8 UV): the lane loads its
//   16 levels, the skip test is a vote, the block contexts of the host
//   writer come from the neighbour lanes (shuffles) and across MB edges
//   from the neighbour MBs' levels, the Y2 context's walk to the nearest
//   MB with a Y2 block is a ballot over 32 candidates at once; each lane
//   counts its block's ops, a warp scan gives their offsets, and each lane
//   writes its ops (prob | bit << 8, the tree path, extra bits, sign, the
//   EOB) into a shared ring.
// - Three counters in shared memory order the hand-over: `counted` (MB k
//   takes its start in the lane's op stream once MB k - 1 has counted),
//   `avail` (ops written, published in stream order) and `consumed` (ops
//   the coder has read; a producer writes ring slots only behind it).  An
//   MB with more ops than the ring writes them in rounds of a ring each.
// - The coder warp codes in lockstep on its 32 lanes, each storing the
//   same bytes (a lane that stored alone would make the warp diverge at
//   every byte: twice the time, measured): it waits on `avail`, reads
//   eight ops at a time with one 16-byte shared load (the next eight
//   loaded ahead), and codes them with the step of `boolenc.cuh`, which
//   loads nothing and has no loop.  Once the lane's
//   last op is coded, the CTA resolves the coder's carry marks.
// K14 replaces webp_tpu/ops/token_ops.py:424 encode_mb_headers (with
// header_ops :340): one lane per image continues its frame-header coder
// state with every MB header.  Header ops depend only on the modes, never
// on the coder, so as in the JAX form the whole stream is laid out first
// and coded after: one CTA per image counts each MB's ops (a thread an
// MB), scans the counts, and writes each MB's ops at its start in a
// per-image op stream in global memory (at most kHeaderSlots an MB); then
// one warp codes the stream in lockstep, eight ops a 16-byte load with
// three vectors loaded ahead, so that no table, mode or probability load
// is left on the coder's chain.
// K15 replaces bool_encode_lanes as a kernel of its own: one lane per
// stream of given [T, L] (bit, prob, valid) streams.
//
// Bound.  The bytes: K13 reads each MB's 400 int16 levels once (9.8 MB for
// 8 images at 768x512, 2.9 us at 3.35 TB/s), plus the neighbour blocks of
// its contexts (cached); the operations are a few per coded op.  Neither
// is what limits it: each lane is one dependent chain of coder steps, so
// the floor is the longest lane's op count times one step's latency
// (`webp_coder_chain` times that step on ops held in shared memory).  The
// producers keep the op generation and every memory round trip off that
// chain.  K14 is bound the same way: its longest lane (the image with the
// most header ops) times the step; its count and write phases come first
// (~35 us for a 768x512 image on an H100, `tools/tokens_split.py --probe`).

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
constexpr int kPlaneProbs = 8 * 3 * 11;
// K15: every lane is one warp's thread 0 (lanes sharing a warp would
// diverge, and the warp would run them in turn).
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---- K13's CTA ----
constexpr int kProducers = 3;                       // producer warps; warp kProducers codes
constexpr int kCtaThreads = kWarp * (kProducers + 1);
constexpr int kRing = 8192;                         // ops (uint16) in the ring: 16 KB
constexpr int kRingMask = kRing - 1;
constexpr int kPublish = 256;                       // the coder publishes `consumed` this often
static_assert((kRing & kRingMask) == 0 && kRing % 8 == 0, "the ring is a power of two of vectors");

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
constexpr int kHeaderSlots = 2 + 1 + 3 + 16 * 7 + 3;   // ops an MB at most (HEADER_SLOTS)

// ---- K14's CTA ----
constexpr int kHdrThreads = 1024;  // MBs counted and written at once; warp 0 then codes
constexpr int kHdrWarps = kHdrThreads / kWarp;

__device__ __forceinline__ int ld_volatile(const int* p) {
    return *static_cast<const volatile int*>(p);
}
__device__ __forceinline__ void st_volatile(int* p, int v) { *static_cast<volatile int*>(p) = v; }

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

__device__ __forceinline__ int token_class(int v) {
    return v <= 4 ? v + 1 : 6 + (v >= 7) + (v >= 11) + (v >= 19) + (v >= 35) + (v >= 67);
}

// Ops of one zigzag block coded from position `first` with initial
// context `ctx` (webp_tpu/encode/vp8.py _write_block, token_ops.py
// block_ops), ending one past its last nonzero `end`: with Count, their
// number; else each passed to emit(prob | bit << 8) in stream order.  A Y
// block with a Y2 block ignores its DC in its tokens and contexts, not in
// `end`.
template <bool Count, typename Emit>
__device__ __forceinline__ int block_ops(const int* lv, int first, int end, int ctx,
                                         const uint8_t* pp, const int* tab, Emit&& emit) {
    const int* bands = tab + kBandsOff;
    int ci = ctx, s2 = 0, lastv = 0, count = 0;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
        if (n < first || n >= end) continue;
        const int level = lv[n];
        const int v = abs(level);
        const int cls = token_class(v);
        const int row = s2 * 12 + cls;
        const int len = tab[kTokLen + row];
        const int nb = tab[kCatNbits + cls];
        if (Count) {
            count += len + nb + (cls != 1);
        } else {
            const uint8_t* p = pp + (bands[n] * 3 + ci) * 11;
            for (int k = 0; k < len; ++k) {
                emit(p[tab[kTokNode + row * kTpMax + k]] | tab[kTokBit + row * kTpMax + k] << 8);
            }
            const int extra = v - tab[kCatBase + cls];
            for (int k = 0; k < nb; ++k) {
                emit(tab[kCatProbs + cls * 11 + k] | ((extra >> (nb - 1 - k)) & 1) << 8);
            }
            if (cls != 1) emit(128 | (level < 0) << 8);
        }
        s2 = v == 0;
        ci = min(v, 2);
        lastv = v;
    }
    if (end < 16) {  // the EOB: the token path of class 0 from the full tree
        const int len = tab[kTokLen];
        if (Count) {
            count += len;
        } else {
            const int pos = min(max(first, end), 15);
            const int eob_ctx = end > first ? (lastv == 1 ? 1 : 2) : ctx;
            const uint8_t* p = pp + (bands[pos] * 3 + eob_ctx) * 11;
            for (int k = 0; k < len; ++k) emit(p[tab[kTokNode + k]] | tab[kTokBit + k] << 8);
        }
    }
    return count;
}

// Y2 nonzero flag of the nearest MB at m - k * step (1 <= k <= count) that
// has a Y2 block, 0 when there is none: 32 candidates a ballot, by the
// whole warp.
__device__ int y2_walk_warp(const Levels& L, int m, int step, int count, int lane) {
    for (int base = 0; base < count; base += kWarp) {
        const int k = base + lane + 1;
        const bool ok = k <= count && L.lmode[m - k * step] != 4;
        const unsigned hit = __ballot_sync(kFull, ok);
        if (hit) return any_nz(L.y2 + (m - (base + __ffs(hit)) * step) * 16, 0);
    }
    return 0;
}

// K13's shared state: the op ring, the image's probabilities and the token
// tables, and the hand-over counters.
struct TokShared {
    uint4 ring[kRing / 8];  // ops as prob | bit << 8, two to a word
    uint8_t probs[kProbs];
    int tab[kTokConsts];
    int counted;   // MBs whose op count is known, a prefix
    int next;      // the lane's op stream length over those MBs
    int avail;     // ops written and published, a prefix
    int consumed;  // ops the coder has read, a prefix
    int n_bytes;   // the coder's byte count, for the carry pass
    int lead;
};

// One producer warp (`warp` of kProducers): the ops of the lane's MBs k =
// warp, warp + kProducers, ... into the ring.
__device__ void produce(TokShared& S, const Levels& L, int p, int nparts, int mbw, int mbh,
                        int warp, int lane) {
    uint16_t* ring = reinterpret_cast<uint16_t*>(S.ring);
    const int rows = p < mbh ? (mbh - 1 - p) / nparts + 1 : 0;
    const int n_mb = rows * mbw;
    // Lane `lane` takes block `lane` of each MB: Y2, then Y s = lane - 1,
    // then UV s = lane - 17; lanes 25..31 hold none.
    const bool is_y = lane >= 1 && lane <= 16, is_uv = lane >= 17 && lane < 25;
    const int s = is_y ? lane - 1 : lane - 17;
    const int sy = s >> 2, sx = s & 3;                       // Y
    const int ch = s >> 2, qy = (s & 3) >> 1, qx = s & 1;    // UV
    // In-MB neighbours: the block above and the block to the left.
    const int src_up = is_y && sy > 0 ? lane - 4 : (is_uv && qy > 0 ? lane - 2 : lane);
    const int src_left = (is_y && sx > 0) || (is_uv && qx > 0) ? lane - 1 : lane;
    for (int k = warp; k < n_mb; k += kProducers) {
        const int mx = k % mbw, my = p + (k / mbw) * nparts, m = my * mbw + mx;
        const bool has_y2 = L.lmode[m] != 4;
        const int first = is_y && has_y2 ? 1 : 0;
        const int plane = lane == 0 ? 1 : (is_y ? (has_y2 ? 0 : 3) : 2);
        int lv[16] = {};
        if (lane == 0) {
            load_block(L.y2 + m * 16, lv);
        } else if (is_y) {
            load_block(L.y + (m * 16 + s) * 16, lv);
        } else if (is_uv) {
            load_block(L.uv + (m * 8 + s) * 16, lv);
        }
        // Neighbour flags across the MB's top and left edges.
        int ext_up = 0, ext_left = 0;
        if (is_y) {
            if (sy == 0 && my > 0) ext_up = y_nz(L, m - mbw, 12 + sx);
            if (sx == 0 && mx > 0) ext_left = y_nz(L, m - 1, 4 * sy + 3);
        } else if (is_uv) {
            if (qy == 0 && my > 0) ext_up = uv_nz(L, m - mbw, ch * 4 + 2 + qx);
            if (qx == 0 && mx > 0) ext_left = uv_nz(L, m - 1, ch * 4 + 2 * qy + 1);
        }
        int end = 0;
#pragma unroll
        for (int n = 0; n < 16; ++n) end = lv[n] != 0 ? n + 1 : end;
        int count = 0, ctx = 0;
        if (__any_sync(kFull, end > 0)) {  // else skipped: the MB header's flag says so
            const int nz = end > first;     // the flag the contexts see
            const int up = __shfl_sync(kFull, nz, src_up);
            const int left = __shfl_sync(kFull, nz, src_left);
            int y2c = 0;
            if (has_y2) {
                y2c = y2_walk_warp(L, m, mbw, my, lane) + y2_walk_warp(L, m, 1, mx, lane);
            }
            if (lane == 0) {
                ctx = y2c;
            } else if (is_y) {
                ctx = (sy > 0 ? up : ext_up) + (sx > 0 ? left : ext_left);
            } else if (is_uv) {
                ctx = (qy > 0 ? up : ext_up) + (qx > 0 ? left : ext_left);
            }
            if ((lane == 0 && has_y2) || is_y || is_uv) {
                count = block_ops<true>(lv, first, end, ctx, nullptr, S.tab, [](uint32_t) {});
            }
        }
        int incl = count;  // inclusive scan of the blocks' op counts
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
            const int t = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += t;
        }
        const int total = __shfl_sync(kFull, incl, kWarp - 1);
        int start = 0;
        if (lane == 0) {  // the MB's start: the end of MB k - 1's ops
            while (ld_volatile(&S.counted) != k) __nanosleep(32);
            __threadfence_block();
            start = ld_volatile(&S.next);
            st_volatile(&S.next, start + total);
            __threadfence_block();
            st_volatile(&S.counted, k + 1);
        }
        __syncwarp();
        start = __shfl_sync(kFull, start, 0);
        const int base = start + incl - count;
        for (int rs = start; rs < start + total; rs += kRing) {  // rounds of at most a ring
            const int re = min(start + total, rs + kRing);
            if (lane == 0) {
                while (ld_volatile(&S.consumed) < re - kRing) __nanosleep(64);
            }
            __syncwarp();
            __threadfence_block();
            if (count > 0) {
                int at = base;
                block_ops<false>(lv, first, end, ctx, S.probs + plane * kPlaneProbs, S.tab,
                                 [&](uint32_t op) {
                                     if (at >= rs && at < re) ring[at & kRingMask] = op;
                                     ++at;
                                 });
            }
            __threadfence_block();
            __syncwarp();
            if (lane == 0) {  // publish in stream order
                while (ld_volatile(&S.avail) != rs) __nanosleep(32);
                __threadfence_block();
                st_volatile(&S.avail, re);
            }
            __syncwarp();
        }
    }
}

// The coder warp's progress: once every lane has read the ring up to
// `pos`, it is published (every lane stores the same value).
__device__ __forceinline__ void publish(int* consumed, int pos) {
    __syncwarp();
    __threadfence_block();
    st_volatile(consumed, pos);
}

// Codes ring ops [pos, lim) (published) on every lane of a warp in
// lockstep; publishes `consumed` every kPublish ops.  Returns lim.
__device__ __forceinline__ int code_span(LaneCoder& c, const uint4* ring, int pos, int lim,
                                         int* consumed) {
    const uint16_t* ops = reinterpret_cast<const uint16_t*>(ring);
    for (; pos < lim && (pos & 7); ++pos) c.put_op(ops[pos & kRingMask]);
    if (pos + 8 <= lim) {
        uint4 v = ring[(pos & kRingMask) >> 3];
        for (;;) {
            const uint4 ahead = ring[((pos + 8) & kRingMask) >> 3];  // used only if published
            c.put8(v);
            pos += 8;
            if ((pos & (kPublish - 1)) == 0) publish(consumed, pos);
            if (pos + 8 > lim) break;
            v = ahead;
        }
    }
    for (; pos < lim; ++pos) c.put_op(ops[pos & kRingMask]);
    return pos;
}

// The coder warp: codes the lane's op stream as the producers publish it.
__device__ void consume(TokShared& S, LaneCoder& c, int n_mb) {
    int pos = 0;
    for (;;) {
        int lim = __shfl_sync(kFull, ld_volatile(&S.avail), 0);
        if (lim == pos) {
            // Done once every MB is counted and the stream's end is coded.
            const int counted = __shfl_sync(kFull, ld_volatile(&S.counted), 0);
            __threadfence_block();
            if (counted == n_mb && __shfl_sync(kFull, ld_volatile(&S.next), 0) == pos) break;
            continue;
        }
        __threadfence_block();
        pos = code_span(c, S.ring, pos, lim, &S.consumed);
        publish(&S.consumed, pos);
    }
}

__global__ void __launch_bounds__(kCtaThreads) coeff_tokens_kernel(
    const uint8_t* __restrict__ lmode, long long lm_bs, const int16_t* __restrict__ y2,
    const int16_t* __restrict__ y, const int16_t* __restrict__ uv,
    const uint8_t* __restrict__ probs, const int* __restrict__ consts, int mbw, int mbh,
    int nparts, int cap, uint8_t* __restrict__ data, uint32_t* __restrict__ carries,
    long long* __restrict__ info) {
    __shared__ TokShared S;
    const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
    const int b = blockIdx.x / nparts, p = blockIdx.x % nparts;
    const long long lane_id = static_cast<long long>(b) * nparts + p;
    uint8_t* out = data + lane_id * cap;
    uint32_t* marks = carries + lane_id * carry_words(cap);
    for (int k = tid; k < kProbs; k += kCtaThreads) S.probs[k] = probs[b * kProbs + k];
    for (int k = tid; k < kTokConsts; k += kCtaThreads) S.tab[k] = consts[k];
    clear_carries(marks, cap, tid, kCtaThreads);
    if (tid == 0) S.counted = S.next = S.avail = S.consumed = S.lead = 0;
    __syncthreads();

    const int nmb = mbw * mbh;
    const long long img = static_cast<long long>(b) * nmb;
    const Levels L{lmode + b * lm_bs, y2 + img * 16, y + img * 256, uv + img * 128};
    LaneCoder c;
    if (warp < kProducers) {
        produce(S, L, p, nparts, mbw, mbh, warp, lane);
    } else {
        const int rows = p < mbh ? (mbh - 1 - p) / nparts + 1 : 0;
        c.init(0, 255, 24, out, cap, marks);
        consume(S, c, rows * mbw);
        if (lane == 0) S.n_bytes = c.n;
    }
    __syncthreads();
    resolve_carries(out, marks, S.n_bytes, cap, &S.lead, tid, kCtaThreads);
    __syncthreads();
    if (warp == kProducers && lane == 0) c.finish(info + lane_id * 6, S.lead);
}

// One coder warp on `reps` passes over a ring of kRing ops in shared memory:
// the K13 coder's step with nothing to wait for.
__global__ void __launch_bounds__(kWarp) coder_chain_kernel(
    const uint16_t* __restrict__ ops, int reps, int cap, uint8_t* __restrict__ data,
    uint32_t* __restrict__ carries, long long* __restrict__ info) {
    __shared__ uint4 ring[kRing / 8];
    __shared__ int consumed, lead;
    const int lane = threadIdx.x;
    const uint4* src = reinterpret_cast<const uint4*>(ops);
    for (int k = lane; k < kRing / 8; k += kWarp) ring[k] = src[k];
    clear_carries(carries, cap, lane, kWarp);
    if (lane == 0) consumed = lead = 0;
    __syncthreads();
    LaneCoder c;
    c.init(0, 255, 24, data, cap, carries);
    int pos = 0;
    for (int r = 0; r < reps; ++r) pos = code_span(c, ring, pos, pos + kRing, &consumed);
    __syncthreads();
    resolve_carries(data, carries, c.n, cap, &lead, lane, kWarp);
    __syncthreads();
    if (lane == 0) c.finish(info, lead);
}

// ---- K14: the MB headers ----

__device__ __forceinline__ int byte_of(uint32_t w, int k) { return (w >> (8 * k)) & 0xFF; }

// One image's per-MB uint8 fields.
struct HeaderModes {
    const uint8_t *lm, *bp, *cm, *sid, *sk;
};

// An MB's modes, each clamped to its alphabet (so that no input can make
// an MB take more than kHeaderSlots ops), its B modes four to a word, and
// the B-mode contexts across its top and left edges.
struct MbModes {
    int lm, cm, sid, sk;
    uint32_t bp[4];  // sub-block s in byte s & 3 of bp[s >> 2]
    uint32_t top;    // byte sx: the context above sub-block sx (0 on the frame's top row)
    uint32_t left;   // byte sy: the context left of sub-block 4 sy (0 on its left column)
    __device__ __forceinline__ int sub(int s) const { return byte_of(bp[s >> 2], s & 3); }
};

// The B-mode context a sub-block of luma mode lm and B mode bp gives its
// neighbour: its own B mode, or the one its whole-MB luma mode implies.
__device__ __forceinline__ int edge_context(int lm, int bp, const int* tab) {
    lm = min(lm, 4);
    return lm == 4 ? min(bp, 9) : tab[kImplied + lm];
}

// MB m's modes and edge contexts: every load issued at once, none waiting
// on another.
__device__ __forceinline__ MbModes load_modes(const HeaderModes& H, const int* tab, int m,
                                              int mbw) {
    const bool has_top = m >= mbw, has_left = m % mbw > 0;
    const int lm = H.lm[m], cm = H.cm[m], sid = H.sid[m], sk = H.sk[m];
    const int top_lm = has_top ? H.lm[m - mbw] : 0, left_lm = has_left ? H.lm[m - 1] : 0;
    int own[16], top[4], left[4];
#pragma unroll
    for (int s = 0; s < 16; ++s) own[s] = H.bp[m * 16 + s];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        top[k] = has_top ? H.bp[(m - mbw) * 16 + 12 + k] : 0;
        left[k] = has_left ? H.bp[(m - 1) * 16 + 4 * k + 3] : 0;
    }
    MbModes q;
    q.lm = min(lm, 4);
    q.cm = min(cm, 3);
    q.sid = min(sid, 3);
    q.sk = sk != 0;
    q.top = q.left = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        q.bp[w] = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            q.bp[w] |= static_cast<uint32_t>(min(own[4 * w + k], 9)) << (8 * k);
        }
        if (has_top) q.top |= static_cast<uint32_t>(edge_context(top_lm, top[w], tab)) << (8 * w);
        if (has_left) {
            q.left |= static_cast<uint32_t>(edge_context(left_lm, left[w], tab)) << (8 * w);
        }
    }
    return q;
}

// The MB's op count: the segment path (when the frame writes the map), the
// skip flag, the luma mode's path, the 16 B modes' paths (lm == 4 only)
// and the chroma mode's path.
__device__ __forceinline__ int mb_op_count(const MbModes& q, const int* tab, bool write_segments) {
    int n = (write_segments ? tab[kSegOff + q.sid] : 0) + 1 + tab[kYmOff + q.lm]
            + tab[kUvOff + q.cm];
    if (q.lm == 4) {
#pragma unroll
        for (int s = 0; s < 16; ++s) n += tab[kBpOff + q.sub(s)];
    }
    return n;
}

// Writes symbol `sym`'s path in the tree at `Off` of the header tables
// `tab` as ops prob | bit << 8, node k's probability probs[node]; returns
// the slot after the last.
template <int Off, int NSym, int Max, typename P>
__device__ __forceinline__ uint16_t* write_path(uint16_t* dst, const int* tab, int sym,
                                                const P* probs) {
    constexpr int kBit = Off + NSym, kNode = kBit + NSym * Max;
    const int len = tab[Off + sym];
#pragma unroll
    for (int k = 0; k < Max; ++k) {
        if (k < len) {
            dst[k] = static_cast<uint16_t>(probs[tab[kNode + sym * Max + k]]
                                           | tab[kBit + sym * Max + k] << 8);
        }
    }
    return dst + len;
}

// MB m's ops from `dst` on, in the host writer's order: segment id, skip
// flag, luma mode, the 16 B modes in raster order under their (top, left)
// mode contexts, chroma mode.
__device__ void write_mb(uint16_t* dst, const MbModes& q, const int* tab, const int* seg_probs,
                         int skip_prob, bool write_segments) {
    if (write_segments) dst = write_path<kSegOff, 4, 2>(dst, tab, q.sid, seg_probs);
    *dst++ = static_cast<uint16_t>(skip_prob | q.sk << 8);
    dst = write_path<kYmOff, 5, 3>(dst, tab, q.lm, tab + kYmProbs);
    if (q.lm == 4) {
#pragma unroll
        for (int s = 0; s < 16; ++s) {
            const int sy = s >> 2, sx = s & 3;
            const int top = sy > 0 ? q.sub(s - 4) : byte_of(q.top, sx);
            const int left = sx > 0 ? q.sub(s - 1) : byte_of(q.left, sy);
            dst = write_path<kBpOff, 10, 7>(dst, tab, q.sub(s),
                                            tab + kBpProbs + (top * 10 + left) * 9);
        }
    }
    write_path<kUvOff, 4, 3>(dst, tab, q.cm, tab + kUvProbs);
}

// The exclusive prefix sum of v over the CTA's kHdrThreads threads, and
// the sum of all (`total`); every thread must call it.
__device__ __forceinline__ int cta_exclusive_scan(int v, int* warp_sums, int& total) {
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    int incl = v;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += t;
    }
    if (lane == kWarp - 1) warp_sums[warp] = incl;
    __syncthreads();
    int before = 0;
    total = 0;
#pragma unroll
    for (int w = 0; w < kHdrWarps; ++w) {
        const int s = warp_sums[w];
        before += w < warp ? s : 0;
        total += s;
    }
    __syncthreads();  // warp_sums is written again by the next call
    return before + incl - v;
}

// Codes ops [0, n) of `ops` (16-byte aligned; vectors up to `last_vec`
// readable) on every lane of a warp in lockstep: eight ops a 16-byte
// load, three vectors loaded ahead of the one being coded.
__device__ __forceinline__ void code_stream(LaneCoder& c, const uint16_t* ops, int n,
                                            int last_vec) {
    const uint4* v = reinterpret_cast<const uint4*>(ops);
    const int nvec = n >> 3;
    uint4 a = v[0], b = v[min(1, last_vec)], d = v[min(2, last_vec)];
    for (int i = 0; i < nvec; ++i) {
        const uint4 e = v[min(i + 3, last_vec)];
        c.put8(a);
        a = b;
        b = d;
        d = e;
    }
    for (int k = nvec * 8; k < n; ++k) c.put_op(ops[k]);
}

// One CTA per image.  Its threads count the ops of the MBs m = tid, tid +
// kHdrThreads, ... a chunk of kHdrThreads MBs at a time, scan the counts,
// and write each MB's ops at its start in the image's op stream `ops`
// (global memory, op_cap ops an image); then warp 0 codes the stream,
// continuing the frame header's coder, and the CTA resolves its carries.
__global__ void __launch_bounds__(kHdrThreads) mb_headers_kernel(
    const uint8_t* __restrict__ lmode, long long lm_bs, const uint8_t* __restrict__ bpred,
    long long bp_bs, const uint8_t* __restrict__ cmode, long long cm_bs,
    const uint8_t* __restrict__ sid, long long sid_bs, const uint8_t* __restrict__ skipped,
    long long sk_bs, const long long* __restrict__ params, const int* __restrict__ consts,
    int mbw, int mbh, int cap, uint8_t* __restrict__ data, uint32_t* __restrict__ carries,
    uint16_t* __restrict__ ops, int op_cap, long long* __restrict__ info) {
    __shared__ int tab[kHdrConsts];
    __shared__ int warp_sums[kHdrWarps];
    __shared__ int seg_probs[3];
    __shared__ int n_bytes, lead;
    const int b = blockIdx.x, tid = threadIdx.x;
    uint8_t* out = data + static_cast<long long>(b) * cap;
    uint32_t* marks = carries + static_cast<long long>(b) * carry_words(cap);
    uint16_t* stream = ops + static_cast<long long>(b) * op_cap;
    // params [8]: write_segments, the 3 segment-tree probabilities,
    // skip_prob, the frame header's (bottom, range, bit_num).
    const long long* pr = params + b * 8;
    for (int k = tid; k < kHdrConsts; k += kHdrThreads) tab[k] = consts[k];
    if (tid < 3) seg_probs[tid] = static_cast<int>(pr[1 + tid]);
    clear_carries(marks, cap, tid, kHdrThreads);
    if (tid == 0) lead = 0;
    __syncthreads();

    const bool write_segments = pr[0] != 0;
    const int skip_prob = static_cast<int>(pr[4]);
    const HeaderModes H{lmode + b * lm_bs, bpred + b * bp_bs, cmode + b * cm_bs,
                        sid + b * sid_bs, skipped + b * sk_bs};
    const int nmb = mbw * mbh;
    int base = 0;  // ops of the chunks before
    for (int m0 = 0; m0 < nmb; m0 += kHdrThreads) {
        const int m = m0 + tid;
        MbModes q{};
        int count = 0;
        if (m < nmb) {
            q = load_modes(H, tab, m, mbw);
            count = mb_op_count(q, tab, write_segments);
        }
        int total;
        const int start = base + cta_exclusive_scan(count, warp_sums, total);
        if (m < nmb) write_mb(stream + start, q, tab, seg_probs, skip_prob, write_segments);
        base += total;
    }
    __syncthreads();  // the stream, written by every thread, is read by warp 0

    LaneCoder c;
    if (tid < kWarp) {
        c.init(static_cast<uint32_t>(pr[5]), static_cast<int>(pr[6]), static_cast<int>(pr[7]), out,
               cap, marks);
        code_stream(c, stream, base, op_cap / 8 - 1);
        if (tid == 0) n_bytes = c.n;
    }
    __syncthreads();
    resolve_carries(out, marks, n_bytes, cap, &lead, tid, kHdrThreads);
    __syncthreads();
    if (tid == 0) c.finish(info + b * 6, lead);
}

__global__ void __launch_bounds__(kWarp) bool_lanes_kernel(
    const uint8_t* __restrict__ bits, const uint8_t* __restrict__ probs,
    const uint8_t* __restrict__ valid, int steps, int lanes,
    const long long* __restrict__ state, int cap, uint8_t* __restrict__ data,
    uint32_t* __restrict__ carries, long long* __restrict__ info) {
    __shared__ int n_bytes, lead;
    const int l = blockIdx.x;
    uint8_t* out = data + static_cast<long long>(l) * cap;
    uint32_t* marks = carries + static_cast<long long>(l) * carry_words(cap);
    clear_carries(marks, cap, threadIdx.x, kWarp);
    if (threadIdx.x == 0) lead = 0;
    __syncthreads();
    LaneCoder c;
    c.init(static_cast<uint32_t>(state[l * 3]), static_cast<int>(state[l * 3 + 1]),
           static_cast<int>(state[l * 3 + 2]), out, cap, marks);
    if (threadIdx.x == 0) {
        for (long long t = 0; t < steps; ++t) {
            const long long i = t * lanes + l;
            if (valid[i]) c.put(bits[i], probs[i]);
        }
        n_bytes = c.n;
    }
    __syncthreads();
    resolve_carries(out, marks, n_bytes, cap, &lead, threadIdx.x, kWarp);
    __syncthreads();
    if (threadIdx.x == 0) c.finish(info + static_cast<long long>(l) * 6, lead);
}

}  // namespace

// levels int16 dense [B][nmb][...], probs uint8 [B][1056], consts int32
// [n_consts]; data uint8 [B][nparts][cap] zero-filled, carry-mask scratch
// uint32 [B][nparts][carry_words(cap)], info int64 [B][nparts][6] out.
WEBP_API int webp_coeff_tokens(const void* lmode, long long lm_bs, const void* y2, const void* y,
                               const void* uv, const void* probs, const void* consts,
                               int n_consts, int mbw, int mbh, int batch, int nparts, int cap,
                               void* data, void* carries, void* info, void* stream) {
    if (n_consts != kTokConsts || nparts < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    coeff_tokens_kernel<<<batch * nparts, kCtaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(lmode), lm_bs, static_cast<const int16_t*>(y2),
        static_cast<const int16_t*>(y), static_cast<const int16_t*>(uv),
        static_cast<const uint8_t*>(probs), static_cast<const int*>(consts), mbw, mbh, nparts,
        cap, static_cast<uint8_t*>(data), static_cast<uint32_t*>(carries),
        static_cast<long long*>(info));
    return static_cast<int>(cudaGetLastError());
}

// The K13 CTAs the card keeps resident at once (the occupancy API over all
// SMs), -1 on an error.
WEBP_API int webp_coeff_tokens_resident() {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, coeff_tokens_kernel,
                                                         kCtaThreads, 0) != cudaSuccess)
        return -1;
    return per_sm * sms;
}

// K13's ring size in ops.
WEBP_API int webp_coeff_tokens_ring() { return kRing; }

// ops uint16 [kRing] (prob | bit << 8); data uint8 [cap] zero-filled,
// carry-mask scratch uint32 [carry_words(cap)], info int64 [6] out.
WEBP_API int webp_coder_chain(const void* ops, int reps, int cap, void* data, void* carries,
                              void* info, void* stream) {
    coder_chain_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(ops), reps, cap, static_cast<uint8_t*>(data),
        static_cast<uint32_t*>(carries), static_cast<long long*>(info));
    return static_cast<int>(cudaGetLastError());
}

// Per-MB uint8 fields with batch strides (bpred [B][nmb][16]); params int64
// [B][8]; data uint8 [B][cap] zero-filled, carry-mask scratch uint32
// [B][carry_words(cap)], op-stream scratch uint16 [B][op_cap] (16-byte
// aligned, op_cap a multiple of 8 and >= nmb * kHeaderSlots), info int64
// [B][6] out.
WEBP_API int webp_mb_headers(const void* lmode, long long lm_bs, const void* bpred,
                             long long bp_bs, const void* cmode, long long cm_bs, const void* sid,
                             long long sid_bs, const void* skipped, long long sk_bs,
                             const void* params, const void* consts, int n_consts, int mbw,
                             int mbh, int batch, int cap, void* data, void* carries, void* ops,
                             int op_cap, void* info, void* stream) {
    if (n_consts != kHdrConsts || op_cap % 8 != 0
        || static_cast<long long>(op_cap) < static_cast<long long>(mbw) * mbh * kHeaderSlots
        || reinterpret_cast<uintptr_t>(ops) % 16 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    mb_headers_kernel<<<batch, kHdrThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(lmode), lm_bs, static_cast<const uint8_t*>(bpred), bp_bs,
        static_cast<const uint8_t*>(cmode), cm_bs, static_cast<const uint8_t*>(sid), sid_bs,
        static_cast<const uint8_t*>(skipped), sk_bs, static_cast<const long long*>(params),
        static_cast<const int*>(consts), mbw, mbh, cap, static_cast<uint8_t*>(data),
        static_cast<uint32_t*>(carries), static_cast<uint16_t*>(ops), op_cap,
        static_cast<long long*>(info));
    return static_cast<int>(cudaGetLastError());
}

// bits, probs, valid uint8 [steps][lanes]; state int64 [lanes][3] (bottom,
// range, bit_num); data uint8 [lanes][cap] zero-filled, carry-mask scratch
// uint32 [lanes][carry_words(cap)], info int64 [lanes][6] out.
WEBP_API int webp_bool_lanes(const void* bits, const void* probs, const void* valid, int steps,
                             int lanes, const void* state, int cap, void* data, void* carries,
                             void* info, void* stream) {
    if (lanes <= 0) return 0;
    bool_lanes_kernel<<<lanes, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bits), static_cast<const uint8_t*>(probs),
        static_cast<const uint8_t*>(valid), steps, lanes, static_cast<const long long*>(state),
        cap, static_cast<uint8_t*>(data), static_cast<uint32_t*>(carries),
        static_cast<long long*>(info));
    return static_cast<int>(cudaGetLastError());
}
