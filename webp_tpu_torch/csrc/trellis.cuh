// The trellis quantization of kernel K5: rate-distortion optimal levels of
// one 4x4 block, on one thread (trellis_dp) or on a half-warp (trellis_dp_half).
//
// Replaces webp_tpu/ops/trellis2.py:110 trellis_par and :325 trellis_spec3
// (libwebp VP8TrellisQuantizeBlock).  Each zigzag position from `first` to
// the last significant one (+1) has two nodes, level0 and level0 + 1 (the
// latter only up to the biased threshold level); a node keeps the cheaper
// of its two predecessors, whose level sets the token context of its rate,
// and the EOB after every nonzero node is scored against the best so far.
// The JAX kernel carries the 64-bit scores as int32 hi/lo pairs, looks the
// rates up through select chains and rebuilds the level fixed cost
// arithmetically, all for the TPU; here scores are int64 in registers and
// rates are shared-memory lookups.  The DP keeps two path scores, two
// contexts and the best terminal; the choice of predecessor of every node
// is one bit of a 32-bit mask, and the levels are rebuilt from level0 at
// the unwind, so a block needs no node arrays.
#pragma once

#include <stdint.h>

__constant__ int kWeightTrellisZz[16] = {30, 27, 27, 19, 24, 19, 11, 17, 17, 11, 10, 12, 10, 8, 8, 6};

constexpr long long kTrellisBig = 1LL << 62;     // score of an invalid node
constexpr int kTrellisTBias = ((0x80 << 17) + 128) >> 8;

// The block's inputs: a = |c| + sharpen per zigzag position, the signs, and
// the last position the DP visits.
struct TrellisBlock {
    int a[16];
    unsigned neg;
    int last;
};

__device__ __forceinline__ int trellis_class(int vc) {
    return (vc >= 1) + (vc >= 2) + (vc >= 3) + (vc >= 4) + (vc >= 5) + (vc >= 7) + (vc >= 11)
           + (vc >= 19) + (vc >= 35) + (vc >= 67);
}

__device__ __forceinline__ int trellis_level0(const TrellisBlock& tb, const int* iq, int n) {
    return min((tb.a[n] * iq[n]) >> 17, 2047);
}

// c_zz: the coefficients in zigzag order; q, iq, sharpen: zigzag vectors.
__device__ void trellis_prepare(const int* c_zz, const int* q, const int* sharpen, int first,
                                TrellisBlock& tb) {
    const int thresh = (q[1] * q[1]) / 4;
    int last = first - 1;
    tb.neg = 0;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
        const int c = c_zz[n];
        tb.a[n] = abs(c) + sharpen[n];
        tb.neg |= static_cast<unsigned>(c < 0) << n;
        if (n >= first && c * c > thresh) last = n;
    }
    tb.last = min(last + 1, 15);
}

// A DP's result: the terminal node (best_n = -1: all levels zero) and the
// predecessor choice of node (n, d) at bit 2n + d.
struct TrellisPath {
    int best_n, best_d;
    unsigned prev;
};

// cls [16][3][11], eob and init [16][3]: the image's costs of the token
// type; fixed: the level fixed costs (sign and extra bits) [2048].
__device__ TrellisPath trellis_dp(const TrellisBlock& tb, const int* q, const int* iq, int lam_i,
                                  int first, int ctx0, const int* cls, const int* eob,
                                  const int* init, const uint16_t* fixed) {
    const long long lam = lam_i;
    long long best = lam * eob[first * 3 + ctx0];  // skip: EOB at `first`
    TrellisPath p = {-1, 0, 0u};
    long long s0 = ctx0 == 0 ? lam * init[first * 3] : 0, s1 = s0;
    int pc0 = ctx0, pc1 = ctx0;
    for (int n = first; n < 16; ++n) {
        const int an = tb.a[n];
        const int l0 = trellis_level0(tb, iq, n);
        const int tl = min((an * iq[n] + kTrellisTBias) >> 17, 2047);
        const long long a2 = static_cast<long long>(an) * an;
        long long ns[2];
        int nc[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
            const int lvl = l0 + d;
            const bool valid = n <= tb.last && lvl <= tl;
            const long long err = an - static_cast<long long>(lvl) * q[n];
            const long long base = 256LL * kWeightTrellisZz[n] * (err * err - a2);
            const int k = trellis_class(min(lvl, 67));
            const int lvf = fixed[min(lvl, 2047)] + (lvl > 0 ? 256 : 0);
            const long long c0 = s0 + lam * (cls[(n * 3 + pc0) * 11 + k] + lvf);
            const long long c1 = s1 + lam * (cls[(n * 3 + pc1) * 11 + k] + lvf);
            const bool take1 = c1 < c0;
            const long long bs = (take1 ? c1 : c0) + base;
            p.prev |= static_cast<unsigned>(take1) << (2 * n + d);
            ns[d] = valid ? bs : kTrellisBig;
            nc[d] = min(lvl, 2);
            const long long term = bs + (n < 15 ? lam * eob[(n + 1) * 3 + min(lvl, 2)] : 0);
            if (valid && lvl != 0 && term < best) {
                best = term;
                p.best_n = n;
                p.best_d = d;
            }
        }
        s0 = ns[0];
        s1 = ns[1];
        pc0 = nc[0];
        pc1 = nc[1];
    }
    return p;
}

// The DP of trellis_dp spread over a half-warp: its 16 lanes call it for
// one block and get the same path (both halves of the warp call it, each
// with its own block and terms).  Lane n brings position n's a = |c| +
// sharpen (an), position n - 1's (ap) and the block's last position.  The
// terms of node (n, d) (its level, whether it is valid, its distortion, its
// rate under each predecessor's token context and the EOB after it) do not
// depend on the path, since a node's context is set by its predecessor's
// level: lane n computes them for d = 0, 1 into terms[.][2n + d] (shared
// memory of the half).  What stays serial is the chain of 16 steps of
// int64 adds and compares, which every lane runs from shared memory.
__device__ TrellisPath trellis_dp_half(int an, int ap, int last, const int* q, const int* iq,
                                       int lam_i, int first, int ctx0, const int* cls,
                                       const int* eob, const int* init, const uint16_t* fixed,
                                       int lane, long long (*terms)[32]) {
    const long long lam = lam_i;
    const int n = lane & 15;
    const int l0 = min((an * iq[n]) >> 17, 2047);
    const int tl = min((an * iq[n] + kTrellisTBias) >> 17, 2047);
    int pc0 = ctx0, pc1 = ctx0;
    if (n > first) {
        const int lp = min((ap * iq[n - 1]) >> 17, 2047);
        pc0 = min(lp, 2);
        pc1 = min(lp + 1, 2);
    }
    int wz = 0;  // kWeightTrellisZz[n], without a lane-indexed constant load
#pragma unroll
    for (int k = 0; k < 16; ++k) wz = k == n ? kWeightTrellisZz[k] : wz;
    unsigned live = 0, ends = 0;  // this lane's two nodes
#pragma unroll
    for (int d = 0; d < 2; ++d) {
        const int lvl = l0 + d;
        const bool valid = n >= first && n <= last && lvl <= tl;
        const long long err = an - static_cast<long long>(lvl) * q[n];
        const long long base = 256LL * wz * (err * err - static_cast<long long>(an) * an);
        const int k = trellis_class(min(lvl, 67));
        const int lvf = fixed[min(lvl, 2047)] + (lvl > 0 ? 256 : 0);
        terms[0][2 * n + d] = lam * (cls[(n * 3 + pc0) * 11 + k] + lvf) + base;  // from (n - 1, 0)
        terms[1][2 * n + d] = lam * (cls[(n * 3 + pc1) * 11 + k] + lvf) + base;  // from (n - 1, 1)
        terms[2][2 * n + d] = n < 15 ? lam * eob[(n + 1) * 3 + min(lvl, 2)] : 0;
        live |= static_cast<unsigned>(valid) << d;
        ends |= static_cast<unsigned>(valid && lvl != 0) << d;  // an EOB may follow
    }
    // Node (m, d)'s flags at bit m of the d-th mask, gathered over the half.
    const int shift = lane & 16;
    const unsigned v0 = __ballot_sync(0xffffffffu, live & 1) >> shift;
    const unsigned v1 = __ballot_sync(0xffffffffu, live & 2) >> shift;
    const unsigned e0 = __ballot_sync(0xffffffffu, ends & 1) >> shift;
    const unsigned e1 = __ballot_sync(0xffffffffu, ends & 2) >> shift;
    __syncwarp();
    long long best = lam * eob[first * 3 + ctx0];  // skip: EOB at `first`
    TrellisPath p = {-1, 0, 0u};
    long long s0 = ctx0 == 0 ? lam * init[first * 3] : 0, s1 = s0;
#pragma unroll 1  // unrolled, the terms' loads are hoisted into more registers than there are
    for (int m = first; m < 16; ++m) {
        long long ns[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
            const int j = 2 * m + d;
            const long long c0 = s0 + terms[0][j], c1 = s1 + terms[1][j];
            const bool take1 = c1 < c0;
            const long long bs = take1 ? c1 : c0;
            p.prev |= static_cast<unsigned>(take1) << j;
            ns[d] = ((d ? v1 : v0) >> m) & 1 ? bs : kTrellisBig;
            const long long term = bs + terms[2][j];
            if (((d ? e1 : e0) >> m) & 1 && term < best) {
                best = term;
                p.best_n = m;
                p.best_d = d;
            }
        }
        s0 = ns[0];
        s1 = ns[1];
    }
    __syncwarp();  // terms is rewritten by the next call
    return p;
}

// The level offset d (0 or 1, over level0) of each position n on a path,
// at bit n: the unwind's chain of predecessor choices.
__device__ __forceinline__ unsigned trellis_path_bits(const TrellisPath& p, int first) {
    unsigned bits = 0;
    int cur = p.best_d;
#pragma unroll
    for (int n = 15; n >= 0; --n) {
        if (n < first || n > p.best_n) continue;
        bits |= static_cast<unsigned>(cur) << n;
        cur = (p.prev >> (2 * n + cur)) & 1;
    }
    return bits;
}

// The levels (zigzag) of a path.  A path has a nonzero level iff best_n >= 0.
__device__ void trellis_unwind(const TrellisBlock& tb, const TrellisPath& p, const int* iq,
                               int first, int* lv) {
    int cur = p.best_d;
#pragma unroll
    for (int n = 15; n >= 0; --n) {
        if (n < first || n > p.best_n) {
            lv[n] = 0;
            continue;
        }
        const int lvl = trellis_level0(tb, iq, n) + cur;
        lv[n] = (tb.neg >> n) & 1 ? -lvl : lvl;
        cur = (p.prev >> (2 * n + cur)) & 1;
    }
}
