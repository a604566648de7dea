// Kernel K1: coefficient levels -> residual blocks + do_sub flags.
//
// Replaces webp_tpu/ops/sparse.py:129 device_expand_levels_mb (a one-hot
// f32 matmul, there only because gathers are slow on a TPU), the escape
// scatter of webp_tpu/decode/device.py:466 _device_decode_sparse8, and the
// dequant / Y2 IWHT / DC fold / IDCT half of decode/device.py:509
// _decode_core.
//
// Bound: memory.  Per MB it reads 50 bitmap bytes, up to cap_mb value bytes
// (or 800 bytes of dense levels) and 400 dequant factors (cached: 4
// segments per image), and writes 1536 bytes of int32 residuals; the
// arithmetic is a few thousand integer ops.
//
// Design: a CTA of kWarps warps takes a run of consecutive MBs of one
// image, one warp an MB, so that many MBs are in flight on an SM and no
// step of an MB waits on a CTA barrier or on one thread.  Lane k < 25 owns
// block k (slots 16k..16k+15) in registers:
//   - sparse: it reads the block's two bitmap bytes as one 16-bit load; a
//     warp shuffle scan of their popcounts gives its first value's rank;
//   - escapes: the image's escape list ascends, so the warp finds the first
//     entry at or past its MB with a 32-ary search (each lane probes one
//     position a round: 4,096 entries take three rounds), then reads the
//     MB's run 32 entries at a time, and each lane applies those of its own
//     block;
//   - dense: it reads its 16 int16 levels as two 16-byte loads;
//   - it dequantizes with the MB's segment row (two 16-byte loads,
//     issued first: they need only the MB's segment);
//   - lane 24 holds the Y2 block: every lane runs the IWHT in lockstep and
//     lane j < 16 takes DC j from lane 24 by shuffle, where the MB is not
//     B-predicted; then every lane runs its block's IDCT in registers.
// The 24 blocks go through a swizzled shared-memory tile so that the
// warp's residual stores are three contiguous 512-byte int4 rows.

#include "common.cuh"

namespace {

constexpr int kSlots = 400;
constexpr int kBlocks = 25;                // 16 Y, 8 U/V, Y2
constexpr int kWarps = 8;                  // MBs a CTA, one warp each
constexpr int kChunks = 24 * 16 / 4;       // int4 chunks of an MB's residuals
constexpr unsigned kFull = 0xffffffffu;

// Physical chunk of logical chunk c in a warp's tile: lane k's four writes
// (chunks 4k..4k+3, one at a time across the warp) and the warp's reads
// (32 consecutive chunks) each fall on eight distinct 16-byte bank groups
// per quarter warp.
__device__ __forceinline__ int swizzle(int c) { return (c & ~7) | ((c + (c >> 3)) & 7); }

// 16 consecutive int16, packed two a word: fetched as two 16-byte loads
// where `vec`, and unpacked only where the values are used, so that the
// loads can be issued ahead of other work.
struct Row16 { int w[8]; };

__device__ __forceinline__ Row16 fetch16(const int16_t* __restrict__ p, bool vec) {
    Row16 r;
    if (vec) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(p));
        const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
        r = {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
            r.w[i] = static_cast<int>(static_cast<uint16_t>(p[2 * i])
                                      | static_cast<unsigned>(static_cast<uint16_t>(p[2 * i + 1])) << 16);
    }
    return r;
}

__device__ __forceinline__ void unpack16(const Row16& r, int* out) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        out[2 * i] = static_cast<int16_t>(r.w[i] & 0xffff);
        out[2 * i + 1] = r.w[i] >> 16;
    }
}

__global__ void __launch_bounds__(kWarps * 32) residual_kernel(
    const uint8_t* __restrict__ bitmap, const int8_t* __restrict__ vals, int cap,
    const int32_t* __restrict__ esc_pos, const int16_t* __restrict__ esc_val, int n_esc,
    const int16_t* __restrict__ levels, long long lv_stride,
    const int16_t* __restrict__ qtab, long long q_stride,
    const uint8_t* __restrict__ seg, long long seg_bs,
    const uint8_t* __restrict__ lmode, long long lm_bs,
    const uint8_t* __restrict__ skipped, long long skip_bs,
    const uint8_t* __restrict__ non_zero, long long nz_bs,
    int nmb, bool vec, int32_t* __restrict__ res, uint8_t* __restrict__ do_sub) {
    __shared__ int4 tile[kWarps][kChunks];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int m = blockIdx.x * kWarps + warp, b = blockIdx.y;
    if (m >= nmb) return;  // the run's ragged tail: whole warps leave
    const long long mb = static_cast<long long>(b) * nmb + m;
    const bool owner = lane < kBlocks;

    // The MB's fields (one broadcast load each).
    const int s = seg[b * seg_bs + m];
    const int lm = lmode[b * lm_bs + m];
    const bool sub = lm == 4 || (!skipped[b * skip_bs + m] && non_zero[b * nz_bs + m]);
    // The MB's dequant row needs only s: its loads go out before the levels'.
    Row16 qrow = {};
    if (owner) qrow = fetch16(qtab + b * q_stride + s * kSlots + 16 * lane, vec);

    int lv[16];
    if (bitmap != nullptr) {
        // Sparse: byte j of the MB's 50-byte bitmap covers slots 8j..8j+7,
        // MSB first, so slot 16k + i is bit 15 - i of (byte 2k, byte 2k+1).
        unsigned bits = 0;
        if (owner) {
            const uint8_t* bm = bitmap + mb * (kSlots / 8) + 2 * lane;
            const unsigned h = vec ? *reinterpret_cast<const uint16_t*>(bm)
                                   : bm[0] | (static_cast<unsigned>(bm[1]) << 8);
            bits = ((h & 0xffu) << 8) | (h >> 8);
        }
        const int count = __popc(bits);
        int upto = count;  // inclusive scan over the lanes
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(kFull, upto, d);
            if (lane >= d) upto += t;
        }
        int rank = upto - count;
        const int8_t* v = vals + mb * cap;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            int val = 0;
            if ((bits >> (15 - i)) & 1) {
                val = rank < cap ? v[rank] : 0;
                ++rank;
            }
            lv[i] = val;
        }

        // Escapes: lower bound of m*400 in the image's ascending list.  The
        // unknown entries are [lo, hi); hi is n_esc or an entry >= m*400.
        const int32_t* pos = esc_pos + static_cast<long long>(b) * n_esc;
        const int16_t* eval = esc_val + static_cast<long long>(b) * n_esc;
        const int lo_pos = m * kSlots, hi_pos = lo_pos + kSlots;
        int lo = 0, hi = n_esc;
        while (lo < hi) {
            const int step = (hi - lo + 31) >> 5;
            const int probe = lo + (lane + 1) * step - 1;
            const unsigned ge = __ballot_sync(kFull, probe >= hi || pos[probe] >= lo_pos);
            if (ge == 0) {
                lo = hi;
            } else {
                const int f = __ffs(ge) - 1;
                hi = min(lo + (f + 1) * step - 1, hi);
                lo += f * step;
            }
        }
        // The MB's run: entries from lo while below (m+1)*400.
        for (int i0 = lo; i0 < n_esc; i0 += 32) {
            const int i = i0 + lane;
            const int p = i < n_esc ? pos[i] : hi_pos;
            const bool in = p < hi_pos;
            const int e = in ? eval[i] : 0;
            unsigned todo = __ballot_sync(kFull, in);
            const bool more = todo == kFull;
            while (todo) {
                const int src = __ffs(todo) - 1;
                todo &= todo - 1;
                const int slot = __shfl_sync(kFull, p, src) - lo_pos;
                const int val = __shfl_sync(kFull, e, src);
                // One bit for the owner's register j, so that the write
                // stays 16 predicated moves and lv never needs an address.
                const unsigned hit = (slot >> 4) == lane ? 1u << (slot & 15) : 0u;
#pragma unroll
                for (int j = 0; j < 16; ++j)
                    if ((hit >> j) & 1) lv[j] = val;
            }
            if (!more) break;
        }
    } else if (owner) {
        unpack16(fetch16(levels + b * lv_stride + static_cast<long long>(m) * kSlots + 16 * lane, vec),
                 lv);
    } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) lv[j] = 0;
    }

    // Dequantize with the MB's segment row.
    if (owner) {
        int q[16];
        unpack16(qrow, q);
#pragma unroll
        for (int j = 0; j < 16; ++j) lv[j] *= q[j];
    }

    // Y2 replaces the Y DCs of every MB that is not B-predicted.
    if (lm != 4) {
        int dc[16];
        iwht4x4(lv, dc);  // lane 24's is the Y2 block's
        int mine = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int d = __shfl_sync(kFull, dc[j], 24);
            if (lane == j) mine = d;
        }
        if (lane < 16) lv[0] = mine;
    }

    // The IDCT runs on every block: for an AC-free block it equals the
    // (dc + 4) >> 3 shortcut exactly.
    idct4x4(lv);
    int4* t = tile[warp];
    if (lane < 24) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            t[swizzle(4 * lane + i)] = make_int4(lv[4 * i], lv[4 * i + 1], lv[4 * i + 2], lv[4 * i + 3]);
    }
    __syncwarp();
    int4* out = reinterpret_cast<int4*>(res + mb * (24 * 16));
#pragma unroll
    for (int r = 0; r < kChunks / 32; ++r) out[32 * r + lane] = t[swizzle(32 * r + lane)];
    if (lane == 0) do_sub[mb] = sub ? 1 : 0;
}

bool aligned(const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

WEBP_API int webp_residual(
    const void* bitmap, const void* vals, int cap,
    const void* esc_pos, const void* esc_val, int n_esc,
    const void* levels, long long lv_stride,
    const void* qtab, long long q_stride,
    const void* seg, long long seg_bs, const void* lmode, long long lm_bs,
    const void* skipped, long long skip_bs, const void* non_zero, long long nz_bs,
    int nmb, int batch, void* res, void* do_sub, void* stream) {
    if (nmb <= 0 || batch <= 0) return 0;
    // 16-byte loads of levels and dequant rows, 2-byte loads of bitmap pairs.
    const bool vec = (bitmap == nullptr || aligned(bitmap, 2))
                     && (levels == nullptr || (aligned(levels, 16) && lv_stride % 8 == 0))
                     && aligned(qtab, 16) && q_stride % 8 == 0;
    const dim3 grid((nmb + kWarps - 1) / kWarps, batch);
    residual_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bitmap), static_cast<const int8_t*>(vals), cap,
        static_cast<const int32_t*>(esc_pos), static_cast<const int16_t*>(esc_val), n_esc,
        static_cast<const int16_t*>(levels), lv_stride,
        static_cast<const int16_t*>(qtab), q_stride,
        static_cast<const uint8_t*>(seg), seg_bs, static_cast<const uint8_t*>(lmode), lm_bs,
        static_cast<const uint8_t*>(skipped), skip_bs, static_cast<const uint8_t*>(non_zero), nz_bs,
        nmb, vec, static_cast<int32_t*>(res), static_cast<uint8_t*>(do_sub));
    return static_cast<int>(cudaGetLastError());
}
