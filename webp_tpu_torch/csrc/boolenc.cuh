// The VP8 boolean (range) coder of RFC 6386 section 7.3 for one lane, in
// registers: the serial coder of `encode/boolenc.py:BoolEncoder`.  Shared
// by K13 (coefficient partitions), K14 (MB headers) and K15 (given op
// streams), in `tokens.cu`.
//
// A step makes no memory load and has no loop, so a lane's chain of steps
// waits on nothing but its own registers:
// - the renormalisation is closed form, as in the twin
//   (`ops/boolenc2.py` `_apply_op`): s = clz(range) - 24 doublings bring the
//   range back to >= 128, and at most one byte leaves, at doubling
//   bit_num when bit_num <= s;
// - a carry is not walked back through the bytes: the step stores each
//   byte as it leaves and marks a carry in a bit mask (`carries`, bit q: a
//   carry into bytes [0, q)), and `resolve_carries` applies the marks once
//   the lane's last op is coded, all of them in parallel.
//
// Why that is exact.  Between two emitted bytes the coder's interval only
// shrinks while it is doubled 8 times, and right after an emission bottom
// < 2^24 and range <= 255; so at the next emission bottom + range < 2^32 +
// 2^16.  Hence a carry happens only at the doubling that emits a byte, at
// most once, and the byte it emits is then 0x00.  A carry at q adds 1 to
// bytes [0, q): it turns the 0xFF bytes before q into 0x00 and adds 1 to
// the first byte before them that is not 0xFF, or to `lead` if there is
// none.  Its walk stops at or after the previous carry's byte (0x00), so
// two carries' walks touch disjoint bytes and their order does not
// matter.  The JAX package (webp_tpu/ops/boolenc2.py:89) resolves the same
// carries by carry lookahead; both give the same `lead`, bytes, count and
// final (bottom, range, bit_num).  The flush stays on the host
// (`encode/boolenc.py:assemble_lane`), since a header lane continues a
// host-written prefix.
//
// Capacity: past `cap` bytes are counted and not written, and a carry
// into more than `cap` bytes is dropped (the lane's bytes are then not
// valid; `n` stays exact, and the wrapper relaunches at that size).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// 32-bit words of a lane's carry mask at byte capacity `cap`.
__host__ __device__ __forceinline__ int carry_words(int cap) { return (cap >> 5) + 1; }

// *p = v, and *p |= v, where `ok`, each as one predicated instruction: no
// branch, so the step does not wait on `ok` (a branch on the emitted byte
// made K13 5–14% slower on an H100).
__device__ __forceinline__ void store_byte_if(uint8_t* p, uint32_t v, bool ok) {
#ifdef __CUDA_ARCH__
    asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q st.global.u8 [%0], %1;\n\t}"
                 ::"l"(p), "r"(v), "r"(static_cast<uint32_t>(ok)));
#else
    if (ok) *p = static_cast<uint8_t>(v);
#endif
}

__device__ __forceinline__ void or_word_if(uint32_t* p, uint32_t v, bool ok) {
#ifdef __CUDA_ARCH__
    asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q red.global.or.b32 [%0], %1;\n\t}"
                 ::"l"(p), "r"(v), "r"(static_cast<uint32_t>(ok)));
#else
    if (ok) atomicOr(p, v);
#endif
}

struct LaneCoder {
    uint32_t bottom;
    int range, bit_num;
    int n;         // bytes emitted; past `cap` they are counted, not written
    int cap;
    int ops;
    uint8_t* out;
    uint32_t* carries;  // [carry_words(cap)], zeroed

    // A warp may run one coder on all its lanes in lockstep: each lane then
    // stores the same byte to the same address, so the warp never diverges.
    __device__ void init(uint32_t b, int r, int bn, uint8_t* o, int c, uint32_t* cm) {
        bottom = b;
        range = r;
        bit_num = bn;
        n = 0;
        ops = 0;
        out = o;
        cap = c;
        carries = cm;
    }

    __device__ __forceinline__ void put(int bit, int prob) {
        const int split = 1 + (((range - 1) * prob) >> 8);
        const uint32_t b2 = bit ? bottom + static_cast<uint32_t>(split) : bottom;
        const int r2 = bit ? range - split : split;
        const int s = __clz(r2) - 24;  // r2 in 1..255
        range = r2 << s;
        const bool emit = bit_num <= s;
        const int j = emit ? bit_num : s;  // doublings up to the byte (or all)
        const uint32_t t = b2 << j;
        store_byte_if(out + n, t >> 24, emit && n < cap);
        // The bit that leaves bottom's top as the byte does: a carry (rare).
        or_word_if(carries + (n >> 5), 1u << (n & 31),
                   emit && __funnelshift_l(b2, 0u, j) != 0 && n <= cap);
        n += emit;
        bottom = (emit ? t & 0xFFFFFFu : t) << (s - j);
        bit_num = emit ? bit_num + 8 - s : bit_num - s;
        ++ops;
    }

    // An op packed as prob | bit << 8.
    __device__ __forceinline__ void put_op(uint32_t op) {
        put(static_cast<int>(op >> 8), static_cast<int>(op & 0xFF));
    }

    // Eight packed ops, two to a word, first the low half.
    __device__ __forceinline__ void put8(uint4 v) {
        put_op(v.x & 0xFFFF);
        put_op(v.x >> 16);
        put_op(v.y & 0xFFFF);
        put_op(v.y >> 16);
        put_op(v.z & 0xFFFF);
        put_op(v.z >> 16);
        put_op(v.w & 0xFFFF);
        put_op(v.w >> 16);
    }

    // info [6]: lead, n_bytes, bottom, range, bit_num, n_ops.
    __device__ void finish(long long* info, int lead) const {
        info[0] = lead;
        info[1] = n;
        info[2] = bottom;
        info[3] = range;
        info[4] = bit_num;
        info[5] = ops;
    }
};

// The carries a lane's coder marked, applied by threads tid = 0..nthr-1 of
// its block after a __syncthreads(): `out` holds the lane's n emitted bytes
// (the first min(n, cap)); carries past the first byte add to *lead.
__device__ __forceinline__ void resolve_carries(uint8_t* out, const uint32_t* carries, int n,
                                                int cap, int* lead, int tid, int nthr) {
    const int top = min(n - 1, cap);  // the last byte index a mark can carry
    for (int w = tid; w <= (top >> 5) && top >= 0; w += nthr) {
        uint32_t m = carries[w];
        while (m) {
            const int q = (w << 5) + __ffs(m) - 1;
            m &= m - 1;
            int i = q - 1;
            while (i >= 0 && out[i] == 0xFF) out[i--] = 0;
            if (i >= 0) {
                ++out[i];
            } else {
                atomicAdd(lead, 1);
            }
        }
    }
}

// Zeroes a lane's carry mask, threads tid = 0..nthr-1 of its block (a
// __syncthreads() must follow before the coder runs).
__device__ __forceinline__ void clear_carries(uint32_t* carries, int cap, int tid, int nthr) {
    for (int w = tid; w < carry_words(cap); w += nthr) carries[w] = 0;
}
