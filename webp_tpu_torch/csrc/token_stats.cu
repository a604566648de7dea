// Kernel K6: per-image token statistics of the pass-1 levels.
//
// Replaces webp_tpu/ops/token_stats.py:183 token_stats_device (with
// compute_contexts_j :49, _block_events :90, _accumulate :161): the
// (total, ones) count of every (type, band, context, node) event of the
// token stream, as the host C++ vp8_token_stats walk counts them.
//
// Bound: integer operations (~12 a (block, position), 0.0035 ms at batch 8,
// 768x512), the levels read once (9.8 MB) close behind.  Design, one CTA of
// 8 warps per (image, MB row, run of <= kSeg MBs of it):
//   - stage: the run's levels (800 B an MB) into shared memory by 16-byte
//     cp.async; meanwhile warp 0 finds the run's Y2 context from above by a
//     scan of the columns' luma modes above it, a few rows at a time (the
//     nearest MB with a Y2 block, as the plain twin's cummax forward fill),
//     and the other warps read the bottom blocks' nonzero flags of the row
//     above, all at once;
//   - contexts: each block's nonzero positions once (a warp an MB, a lane
//     a block), the MB's 25 context flags as one ballot mask, with the skip
//     flag (no nonzero level) derived there unless the caller passes skip
//     flags; the Y2 context from the left is a warp max-scan along the run;
//   - count: the blocks that code tokens as one word each (where their
//     levels are, type, first position, initial context, run end), in three
//     lists by how many lanes their events need (4, 8 or 16: most blocks
//     end early); then a lane per (listed block, position).  Each position
//     makes exactly one event code in closed form: its token class (11, by
//     |level|) inside the block's run, the EOB after it, nothing else; so
//     one shared atomicAdd a position into a histogram indexed by (type,
//     position, context, code), where lanes of a warp share an address only
//     at the same position of different blocks;
//   - flush: a thread per (type, band, context) folds positions into the
//     band and codes into the 11 nodes' (total, ones), and adds the CTA's
//     non-zero counters into a per-image set that the image's last CTA (a
//     ticket) copies out and zeroes for the next call.  One launch a call,
//     no memset; integer counts are exact in any order.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSeg = 64;                       // most MBs a CTA takes from one MB row
constexpr int kMaxChunk = 8;                   // most rows of modes a column scan reads at once
constexpr int kCounters = 4 * 8 * 3 * 11;      // (type, band, context, node)
constexpr int kCodes = 12;                     // 11 token classes, then the EOB
constexpr int kEob = 11;
constexpr int kHist = 4 * 16 * 3 * kCodes;     // (type, position, context, code)

// Byte offsets of the shared-memory regions for a run of `seg` MBs.
struct Layout {
    int y2, y, uv, hist, mask, above, info, y2ctx, top, lists, count, positions, lm, bytes;
};

__host__ __device__ inline Layout layout(int seg) {
    Layout L;
    L.y2 = 0;
    L.y = L.y2 + seg * 32;
    L.uv = L.y + seg * 512;
    L.hist = L.uv + seg * 256;
    L.mask = L.hist + kHist * 4;
    L.above = L.mask + (seg + 1) * 4;
    L.info = L.above + seg * 4;
    L.y2ctx = L.info + seg * 4;
    L.top = L.y2ctx + seg * 4;
    L.lists = L.top + seg * 4;             // three lists of up to seg * 25 blocks
    L.count = L.lists + 3 * seg * 25 * 4;  // their lengths, then the last-CTA flag
    L.positions = L.count + 4 * 4;
    L.lm = L.positions + seg * 25 * 2;
    L.bytes = L.lm + seg;
    return L;
}

// Nonzero flags of a block's 16 levels: bit 0 any, bit 1 any past the first.
__device__ __forceinline__ int nz_bits(const int16_t* blk) {
    uint32_t w[8];
    if (!(reinterpret_cast<uintptr_t>(blk) & 15)) {
        const uint4 a = *reinterpret_cast<const uint4*>(blk);
        const uint4 c = *reinterpret_cast<const uint4*>(blk + 8);
        w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = c.x, w[5] = c.y, w[6] = c.z,
        w[7] = c.w;
    } else {
        for (int k = 0; k < 8; ++k)
            w[k] = static_cast<uint16_t>(blk[2 * k]) | (static_cast<uint32_t>(
                       static_cast<uint16_t>(blk[2 * k + 1])) << 16);
    }
    const uint32_t rest = (w[0] & 0xffff0000u) | w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7];
    return ((rest | (w[0] & 0xffffu)) != 0) | ((rest != 0) << 1);
}

// Nonzero positions of a block's 16 levels (bit n: level n), 16-byte aligned.
__device__ __forceinline__ unsigned nz_positions(const int16_t* blk) {
    const uint4 a = *reinterpret_cast<const uint4*>(blk);
    const uint4 c = *reinterpret_cast<const uint4*>(blk + 8);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        // 0xffff per nonzero level.  (Comparing each half with 0 directly
        // compiled to a mask with levels 6 and 14 swapped.)
        const unsigned ne = __vcmpne2(w[k], 0u);
        m |= ((ne & 1u) | ((ne >> 15) & 2u)) << (2 * k);
    }
    return m;
}

// The blocks of the MB above that its neighbour below reads (Y 12-15, then
// U 2-3 and V 2-3): bit j of above[i] is block kBelow[j]'s flag.
__constant__ int kBelow[8] = {13, 14, 15, 16, 19, 20, 23, 24};

// The context's nonzero flag of block `slot` (0 Y2, 1-16 Y, 17-24 U then V)
// from its nz_bits: Y2 only with a Y2 block, Y past the DC with one.
__device__ __forceinline__ bool ctx_flag(int slot, int bits, bool has_y2) {
    if (slot == 0) return has_y2 && (bits & 1);
    if (slot <= 16 && has_y2) return bits & 2;
    return bits & 1;
}

// Block `slot` of MB m of an image's level arrays.
__device__ __forceinline__ const int16_t* block_of(const int16_t* y2, const int16_t* y,
                                                   const int16_t* uv, long long m, int slot) {
    if (slot == 0) return y2 + m * 16;
    if (slot <= 16) return y + m * 256 + (slot - 1) * 16;
    return uv + m * 128 + (slot - 17) * 16;
}

// Token class of |level| v: 0, 1, 2, 3, 4, 5-6, 7-10, 11-18, 19-34, 35-66, 67+.
__device__ __forceinline__ int token_class(int v) {
    return v <= 4 ? v : 5 + (v > 6) + (v > 10) + (v > 18) + (v > 34) + (v > 66);
}

// Initial context of block `slot` of run MB i: its top and left neighbours'
// flags (mask[i + 1] the MB's, mask[i] the left MB's, `above` the bottom
// blocks' of the MB above, as kBelow orders them).
__device__ __forceinline__ int first_ctx(int slot, int i, const int* mask, unsigned above,
                                         const int* y2ctx) {
    if (slot == 0) return y2ctx[i];
    const unsigned m = mask[i + 1], l = mask[i];
    int top, left;
    if (slot <= 16) {
        const int s = slot - 1, sy = s >> 2, sx = s & 3;
        top = sy > 0 ? (m >> (slot - 4)) & 1 : (above >> sx) & 1;
        left = sx > 0 ? (m >> (slot - 1)) & 1 : (l >> (4 + 4 * sy)) & 1;
    } else {
        const int s = slot - 17, ch = s >> 2, qy = (s >> 1) & 1, qx = s & 1;
        top = qy > 0 ? (m >> (slot - 2)) & 1 : (above >> (4 + ch * 2 + qx)) & 1;
        left = qx > 0 ? (m >> (slot - 1)) & 1 : (l >> (18 + ch * 4 + 2 * qy)) & 1;
    }
    return top + left;
}

__global__ void __launch_bounds__(kThreads) token_stats_kernel(
    const uint8_t* __restrict__ lmode, long long lm_bs, const uint8_t* __restrict__ skipped,
    long long sk_bs, const int16_t* __restrict__ y2, const int16_t* __restrict__ y,
    const int16_t* __restrict__ uv, int mbw, int mbh, int batch, int seg_mbs, int chunk_rows,
    int* __restrict__ out, int* __restrict__ acc) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.z, my = blockIdx.y, x0 = blockIdx.x * seg_mbs;
    const int seg = min(seg_mbs, mbw - x0);
    const Layout L = layout(seg);
    int16_t* s_y2 = reinterpret_cast<int16_t*>(smem + L.y2);
    int16_t* s_y = reinterpret_cast<int16_t*>(smem + L.y);
    int16_t* s_uv = reinterpret_cast<int16_t*>(smem + L.uv);
    int* hist = reinterpret_cast<int*>(smem + L.hist);
    int* mask = reinterpret_cast<int*>(smem + L.mask);
    unsigned* above = reinterpret_cast<unsigned*>(smem + L.above);
    int* info = reinterpret_cast<int*>(smem + L.info);
    int* y2ctx = reinterpret_cast<int*>(smem + L.y2ctx);
    int* top = reinterpret_cast<int*>(smem + L.top);
    unsigned* lists = reinterpret_cast<unsigned*>(smem + L.lists);
    int* count = reinterpret_cast<int*>(smem + L.count);
    uint16_t* positions = reinterpret_cast<uint16_t*>(smem + L.positions);
    uint8_t* lm = smem + L.lm;

    const int nmb = mbw * mbh;
    const long long img = static_cast<long long>(b) * nmb;
    const long long m0 = img + static_cast<long long>(my) * mbw + x0;  // the run's first MB
    const uint8_t* lm_img = lmode + b * lm_bs;

    // 1. Stage the run's levels (asynchronously where aligned), its modes
    //    and skip flags; zero the histogram.
    const bool aligned = !((reinterpret_cast<uintptr_t>(y2) | reinterpret_cast<uintptr_t>(y)
                            | reinterpret_cast<uintptr_t>(uv)) & 15);
    for (int k = tid; k < seg * 50; k += kThreads) {  // 16-byte chunks: 2 Y2, 32 Y, 16 UV an MB
        int16_t* dst;
        const int16_t* src;
        if (k < seg * 2) {
            dst = s_y2 + k * 8, src = y2 + m0 * 16 + k * 8;
        } else if (k < seg * 34) {
            dst = s_y + (k - seg * 2) * 8, src = y + m0 * 256 + (k - seg * 2) * 8;
        } else {
            dst = s_uv + (k - seg * 34) * 8, src = uv + m0 * 128 + (k - seg * 34) * 8;
        }
        if (aligned) {
            cp_async16(dst, src);
        } else {
            for (int e = 0; e < 8; ++e) dst[e] = src[e];
        }
    }
    cp_async_commit();
    for (int k = tid; k < kHist; k += kThreads) hist[k] = 0;
    if (tid < seg) lm[tid] = lm_img[static_cast<long long>(my) * mbw + x0 + tid];
    if (tid < 3) count[tid] = 0;

    // 2. Warp 0, with no CTA barrier: the Y2 context from above (per column
    //    the nearest row above with a Y2 block, from its modes read
    //    chunk_rows rows at a time bottom up, then that block's flag), from
    //    the left of the run (the nearest such column in the row) and the
    //    flags of the MB left of the run.  Meanwhile warps 1-7: the flags of
    //    the row above's bottom blocks (Y 12-15, U and V 2-3: bits 0-7 of
    //    above[i]), eight lanes an MB, all loads at once.
    int left_in = 0;  // warp 0's
    if (warp == 0) {
        for (int c0 = 0; c0 < seg; c0 += 32) {
            const int c = c0 + lane;
            int found = -1;
            for (int hi = my - 1; hi >= 0 && __any_sync(kFull, c < seg && found < 0);
                 hi -= chunk_rows) {
                int modes[kMaxChunk];
#pragma unroll
                for (int r = 0; r < kMaxChunk; ++r)
                    modes[r] = c < seg && r < chunk_rows && hi - r >= 0
                                   ? lm_img[static_cast<long long>(hi - r) * mbw + x0 + c] : 4;
#pragma unroll
                for (int r = 0; r < kMaxChunk; ++r)
                    if (found < 0 && modes[r] != 4) found = hi - r;
            }
            if (c < seg) {
                const long long m = img + static_cast<long long>(found) * mbw + x0 + c;
                top[c] = found < 0 ? 0 : nz_bits(y2 + m * 16) & 1;
            }
        }
        if (lane == 0) mask[0] = 0;
        if (x0 > 0) {
            int left_y2 = -1;
            for (int hi = x0 - 1; hi >= 0 && left_y2 < 0; hi -= 32) {
                const int c = hi - lane;
                const bool has = c >= 0 && lm_img[static_cast<long long>(my) * mbw + c] != 4;
                left_y2 = __reduce_max_sync(kFull, has ? c : -1);
            }
            if (left_y2 >= 0)
                left_in = nz_bits(y2 + (img + static_cast<long long>(my) * mbw + left_y2) * 16) & 1;
            const long long m = img + static_cast<long long>(my) * mbw + x0 - 1;
            const bool has = lm_img[m - img] != 4;
            const bool f = lane < 25 && ctx_flag(lane, nz_bits(block_of(y2, y, uv, m, lane)), has);
            const unsigned bits = __ballot_sync(kFull, f);
            if (lane == 0) mask[0] = static_cast<int>(bits);
        }
    } else if (my > 0) {
        for (int base = (warp - 1) * 32; base < seg * 8; base += kThreads - 32) {
            const int k = base + lane, i = k >> 3, slot = kBelow[k & 7];
            const long long m = m0 - mbw + i;
            const bool f = k < seg * 8
                           && ctx_flag(slot, nz_bits(block_of(y2, y, uv, m, slot)),
                                       lm_img[m - img] != 4);
            const unsigned bits = __ballot_sync(kFull, f);
            if ((lane & 7) == 0 && k < seg * 8) above[i] = (bits >> lane) & 0xffu;
        }
    } else {
        for (int i = tid - 32; i < seg; i += kThreads - 32) above[i] = 0;
    }
    cp_async_wait<0>();
    __syncthreads();

    // 3. The run's masks and skip flags, a warp an MB, each block's nonzero
    //    positions kept (bit n: level n); then the Y2 context from the left
    //    by a max-scan of (column * 2 + flag) along the run.
    for (int i = warp; i < seg; i += kWarps) {
        const bool has = lm[i] != 4;
        const int q = lane == 0 ? i  // the block's index in the staged levels
                      : (lane <= 16 ? seg + i * 16 + lane - 1 : 17 * seg + i * 8 + lane - 17);
        const unsigned nz = lane < 25 ? nz_positions(s_y2 + q * 16) : 0;
        const int bits = (nz != 0) | ((nz > 1) << 1);
        const unsigned flags = __ballot_sync(kFull, lane < 25 && ctx_flag(lane, bits, has));
        const unsigned any = __ballot_sync(kFull, nz != 0);
        if (lane < 25) positions[q] = static_cast<uint16_t>(nz);
        if (lane == 0) {
            const long long m = static_cast<long long>(my) * mbw + x0 + i;
            const bool skip = skipped ? skipped[b * sk_bs + m] != 0 : any == 0;
            mask[i + 1] = static_cast<int>(flags);
            info[i] = skip | (has << 1);
        }
    }
    __syncthreads();
    if (warp == 0) {
        int carry = left_in;
        for (int base = 0; base < seg; base += 32) {
            const int i = base + lane;
            int key = i < seg && lm[i] != 4 ? i * 2 + (mask[i + 1] & 1) : -1;
            for (int off = 1; off < 32; off <<= 1) {
                const int t = __shfl_up_sync(kFull, key, off);
                if (lane >= off) key = max(key, t);
            }
            const int prev = __shfl_up_sync(kFull, key, 1);
            const int left = lane > 0 && prev >= 0 ? prev & 1 : carry;
            if (i < seg) y2ctx[i] = left + top[i];
            const int last = __shfl_sync(kFull, key, 31);
            carry = last >= 0 ? last & 1 : carry;
        }
    }
    __syncthreads();

    // 4. Events.  The blocks that code tokens (not in a skipped MB; Y2 only
    //    with a Y2 block) as one word each: their index in the staged levels
    //    (Y2, then Y, then UV blocks), type, first position, initial context
    //    and run end.  By the position e of their last event (the EOB's, or
    //    the last level's at 15) they go to three lists, of blocks that fit
    //    4, 8 or 16 lanes (e <= 3, e <= 7, else), in any order: counts are
    //    order-free.  Then a lane per (listed block, position), 8, 4 or 2
    //    blocks a warp, one histogram add a position.
    for (int base = warp * 32; base < seg * 25; base += kThreads) {
        const int q = base + lane;
        int i = 0, slot = 0;
        if (q < seg) {
            i = q;
        } else if (q < 17 * seg) {
            i = (q - seg) >> 4, slot = 1 + ((q - seg) & 15);
        } else if (q < 25 * seg) {
            i = (q - 17 * seg) >> 3, slot = 17 + ((q - 17 * seg) & 7);
        }
        const int inf = info[i];
        const bool has = inf & 2;
        unsigned word = 0;
        int cls = 3;  // no list
        if (q < seg * 25 && !(inf & 1) && (slot != 0 || has)) {
            const int ctype = slot == 0 ? 1 : (slot <= 16 ? (has ? 0 : 3) : 2);
            const int first = ctype == 0;
            const unsigned run = positions[q] & ~static_cast<unsigned>(first);
            const int end = run ? 32 - __clz(run) : 0;  // past the last nonzero level
            const int e = end == 0 ? first : min(end, 15);
            cls = e <= 3 ? 0 : (e <= 7 ? 1 : 2);
            word = q | (ctype << 11) | (first << 13)
                   | (first_ctx(slot, i, mask, above[i], y2ctx) << 14) | (end << 16);
        }
        for (int c = 0; c < 3; ++c) {
            const unsigned ballot = __ballot_sync(kFull, cls == c);
            int at = 0;
            if (lane == 0 && ballot) at = atomicAdd(count + c, __popc(ballot));
            at = __shfl_sync(kFull, at, 0) + __popc(ballot & ((1u << lane) - 1));
            if (cls == c) lists[c * seg * 25 + at] = word;
        }
    }
    __syncthreads();
    for (int c = 0; c < 3; ++c) {
        const int per = 8 >> c, shift = 2 + c;  // blocks a warp, log2 lanes a block
        const int n_c = count[c];
        const int g = lane >> shift, n = lane & ((1 << shift) - 1);
        for (int p0 = warp * per; p0 < n_c; p0 += kWarps * per) {
            const bool in = p0 + g < n_c;
            const unsigned word = in ? lists[c * seg * 25 + p0 + g] : 0u;
            const int first = (word >> 13) & 1, end = (word >> 16) & 31;
            const int v = in ? abs(static_cast<int>(s_y2[(word & 0x7ff) * 16 + n])) : 0;
            const int vprev = __shfl_up_sync(kFull, v, 1);  // the group's lane n - 1 for n >= 1
            const int tc = token_class(v);
            const int code = n == first ? (end ? tc : kEob)
                                        : (n < end ? tc : (n == end ? kEob : -1));
            const int ctx = n == first ? (word >> 14) & 3 : min(vprev, 2);
            if (in && n >= first && code >= 0)
                atomicAdd(&hist[((((word >> 11) & 3) * 16 + n) * 3 + ctx) * kCodes + code], 1);
        }
    }
    __syncthreads();

    // 5. The CTA's counters: a thread per (type, band, context) folds the
    //    band's positions and turns the 12 codes into the 11 nodes' (total,
    //    ones), adding the non-zero ones into the image's set; the image's
    //    last CTA copies the set out.
    int* img_acc = acc + static_cast<long long>(b) * (2 * kCounters + 1);
    for (int g = tid; g < kCounters / 11; g += kThreads) {  // g = (type * 8 + band) * 3 + ctx
        const int ctx = g % 3, band = (g / 3) % 8, ctype = g / 24;
        const int* hp = hist + (ctype * 16 * 3 + ctx) * kCodes;  // position 0's codes
        constexpr int kPos = 3 * kCodes;                         // a position's stride
        int f[kCodes];
#pragma unroll
        for (int k = 0; k < kCodes; ++k) {
            if (band == 6) {  // positions 4, 7-14
                f[k] = hp[4 * kPos + k];
#pragma unroll
                for (int p = 7; p <= 14; ++p) f[k] += hp[p * kPos + k];
            } else {          // the band's one position
                f[k] = hp[(band < 4 ? band : (band == 7 ? 15 : band + 1)) * kPos + k];
            }
        }
        const int s2 = f[2] + f[3] + f[4], s34 = f[3] + f[4], s56 = f[5] + f[6];
        const int s78 = f[7] + f[8], s910 = f[9] + f[10];
        const int ge7 = s78 + s910, ge5 = s56 + ge7, ge2 = s2 + ge5, all = f[0] + f[1] + ge2;
        const bool skip = ctx == 0 && band != (ctype == 0 ? 1 : 0);
        const int run = skip ? 0 : all;
        const int tot[11] = {run + f[kEob], all, all - f[0], ge2, s2, s34, ge5, s56, ge7, s78,
                             s910};
        const int ones[11] = {run, all - f[0], ge2, ge5, s34, f[4], ge7, f[6], s910, f[8], f[10]};
#pragma unroll
        for (int node = 0; node < 11; ++node) {
            if (tot[node]) atomicAdd(img_acc + g * 11 + node, tot[node]);
            if (ones[node]) atomicAdd(img_acc + kCounters + g * 11 + node, ones[node]);
        }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        const int ctas = static_cast<int>(gridDim.x) * mbh;
        count[3] = atomicAdd(img_acc + 2 * kCounters, 1) == ctas - 1;
    }
    __syncthreads();
    if (count[3]) {
        __threadfence();
        for (int k = tid; k < 2 * kCounters; k += kThreads) {
            const int val = __ldcg(img_acc + k);
            img_acc[k] = 0;
            const bool ones = k >= kCounters;
            out[(static_cast<long long>(ones ? batch : 0) + b) * kCounters + (k % kCounters)] = val;
        }
        if (tid == 0) img_acc[2 * kCounters] = 0;
    }
}

}  // namespace

// out: int32 [2, batch, 4, 8, 3, 11] (totals, then ones), written whole;
// skipped: null to derive the skip flags from the levels; acc: int32
// [batch, 2 * 1056 + 1], zero before the call and after it.
WEBP_API int webp_token_stats(const void* lmode, long long lm_bs, const void* skipped,
                              long long sk_bs, const void* y2, const void* y, const void* uv,
                              int mbw, int mbh, int batch, int seg_mbs, int chunk_rows, void* out,
                              void* acc, void* stream) {
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    if (seg_mbs <= 0 || seg_mbs > kSeg || chunk_rows <= 0 || chunk_rows > kMaxChunk)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        token_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, layout(kSeg).bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((mbw + seg_mbs - 1) / seg_mbs, mbh, batch);
    token_stats_kernel<<<grid, kThreads, layout(min(seg_mbs, mbw)).bytes,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(lmode), lm_bs, static_cast<const uint8_t*>(skipped), sk_bs,
        static_cast<const int16_t*>(y2), static_cast<const int16_t*>(y),
        static_cast<const int16_t*>(uv), mbw, mbh, batch, seg_mbs, chunk_rows,
        static_cast<int*>(out), static_cast<int*>(acc));
    return static_cast<int>(cudaGetLastError());
}
