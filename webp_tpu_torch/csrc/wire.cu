// Kernels K18 prepack, K19 pack_levels and K20 wire: the encode wire.
//
// K18 replaces webp_tpu/ops/encode_wavefront2.py:1028 _prepack_body (jitted
// as :1076 _prepack_batch and :1087 _prepack_batch_pertbl): K5's levels as
// [y 256 | uv 128 | y2 16] per MB clipped to int8, the first kEsc positions
// with |level| > 127 and their values (padding -1 / 0), an image's overflow
// flag when one of its MBs has more, and meta8 = [bpred 16, luma, chroma].
// The JAX form finds the escapes by kEsc rounds of argmax over the 400 slots.
//
// K19 replaces webp_tpu/ops/sparse.py:73 device_pack_levels_mb (jitted as
// encode_wavefront2.py:1113 _pack_levels_stage): each MB's nonzero bitmap
// (np.packbits order, MSB first) and its first cap nonzeros in slot order,
// with an image's overflow flag when one of its MBs has more.  The JAX form
// is a float32 one-hot matmul per MB.
//
// prepack_pack is K18 then K19 at kCapMb in one launch, as the JAX package
// runs both stages in one program (encode_wavefront2.py:1286
// encode_analysis_batch_v2_pertbl_packed): the main path's call.
//
// K20 replaces encode_wavefront2.py:1200 _wire_stage (with :1178
// _rank_compact, :1149 _i16_le_bytes): one uint8 row per image holding the
// flags, the bitmap, the int4 nibbles of the packed values, the per-MB list
// of the |v| > 7 slots, meta8 and the image list of the escapes.  The JAX
// form compacts both lists with float32 one-hot matmuls, which round the
// positions mb * 400 + pos once they pass 2^24; here every rank is an
// integer (ADVICE r5).
//
// Bound: memory.  K18 reads 818 B and writes 400 + 18 + 16 B per MB, K19
// reads 400 and writes 50 + 256 (at cap 256), the fused kernel K18's bytes
// and K19's writes; K20 reads 50 + 256 + 18 + 16 and writes 260 B per MB.
// A slot costs a few integer operations.
//
// Design of K18, K19 and the fused kernel: one warp per MB (8 warps a block,
// a grid of (MB chunks, images)), a lane per run of 8 slots.  Run r holds
// slots 8r..8r+7; in pass A lane L takes run L (y), in pass B lanes L <
// kRunsB take run 32 + L (uv for L < 16, y2 for 16 and 17).  A warp issues
// all of its MB's loads (16 bytes of levels a lane and pass, K19 8 bytes;
// K18's meta8 source in the same wave) before it uses any, so an MB costs
// one DRAM round trip; the time a warp waits on a chain of loads, not the
// bytes, set the earlier 13-pass kernels' time.  Every rank comes from one
// five-step shuffle scan of a word that holds a lane's pass-A count in its
// low half and its pass-B count in its high half (a run holds at most 8).
// K18 clips two int16 at a time (__vmaxs2 / __vmins2), writes a run's int8
// levels as one 8-byte store, and ranks its escapes only when the warp has
// one (rare), reading their values again from the levels (an L2 hit) so
// that no register holds the raw levels past the clip (48 registers, not
// 52, for the fused kernel: 5 CTAs an SM, not 4).  K19 stores a run's
// nonzero mask as its bitmap byte, scatters the nonzeros into a zeroed
// tile of the warp's in shared memory, and copies the tile out (16-byte
// stores when cap % 16 == 0), which is the zero fill too.  The three
// kernels share prepack_mb and pack_mb, so the fused kernel is K18's loads
// and clip with K19's bitmap, scan and tile applied to the clipped levels
// still in registers (a level is nonzero exactly when its int8 clip is).
//
// Design of K20 (one launch): a CTA of 8 warps takes 32 consecutive MBs of
// an image, a warp four of them, a lane a run of 8 packed values of each.
// A warp issues all of its MBs' loads at once (the run, 8 bytes; the
// bitmap and meta8 2 bytes a lane).  A lane turns its run into 4 nibble
// bytes (one 32-bit word) and its |v| > 7 slots into med entries, ranked
// in slot order by one shuffle scan a pair of MBs (counts in 16-bit
// halves).  The row's regions start at 2 mod 16 at nmb 1,536 (and image
// b's row at 2b mod 16), so the CTA stages each contiguous piece of its
// MBs (bitmap, nibbles, med idx, med val, meta8; zeroed med tiles give the
// padding) in shared memory at the byte offset mod 16 it has in the row,
// and copies it out in 16-byte stores, with narrower aligned stores only
// on the two ragged chunks, which hold no byte of another piece.  A CTA
// more an image (x = 0 of the grid, dispatched first) writes the image
// list beside them, since it needs only the inputs: the (pos, val) pairs
// of 1,024 MBs a round, 4 a thread in one wave of 8-byte loads, ranked by
// the live mask with one block scan, through a zeroed staged tile in
// 16-byte stores, and the overflow flag byte.  Each MB CTA adds 1 to its
// image's ticket word (| 1 << 32 where one of its MBs' med lists is over
// its cap), one atomic whose latency hides under the copy-out; the one
// that completes the count writes the sp_over flag byte and leaves the
// word zero (`_build.kept_zeroed`).  The med flags ride in that word, so
// no fence is needed.

#include "common.cuh"

namespace {

constexpr int kSlots = 400;       // levels per MB
constexpr int kBitmap = kSlots / 8;
constexpr int kEsc = 4;           // N_ESC
constexpr int kCapMb = 256;       // CAP_MB: values the wire packs per MB
constexpr int kMedCap = 32;       // MED_CAP
constexpr int kEscImg = 512;      // ESC_IMG
constexpr int kMeta = 18;
constexpr int kWarps = 8;         // warps (MBs) a block of the per-MB kernels
constexpr int kRunsB = kSlots / 8 - 32;  // runs of pass B: 32..49
constexpr int kTile = kSlots;     // bytes of a warp's vals tile (cap <= 400)
constexpr unsigned kFull = 0xffffffffu;

// Exclusive scan of x over the warp's lanes; `total` gets the sum of all.
// Callers pack two 16-bit counts in x: a half never carries into the other.
__device__ __forceinline__ unsigned exclusive_scan(unsigned x, int lane, unsigned& total) {
    unsigned s = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, s, d);
        if (lane >= d) s += t;
    }
    total = __shfl_sync(kFull, s, 31);
    return s - x;
}

// Two int16 (one word) clipped to [-128, 127] in each half; `esc` gets
// 0xFFFF in each half with |level| > 127 (-128 included).
__device__ __forceinline__ unsigned clip_pair(unsigned w, unsigned& esc) {
    esc = __vcmpgts2(__vabsss2(w), 0x007F007Fu);
    return __vmins2(__vmaxs2(w, 0xFF80FF80u), 0x007F007Fu);
}

// A run's 8 int16 levels -> their int8 clips (slot 8r + i at byte i) and
// `esc`, bit i set where slot 8r + i has |level| > 127.
__device__ __forceinline__ uint2 clip_run(int4 raw, unsigned& esc) {
    unsigned n0, n1, n2, n3;
    const unsigned c0 = clip_pair(static_cast<unsigned>(raw.x), n0);
    const unsigned c1 = clip_pair(static_cast<unsigned>(raw.y), n1);
    const unsigned c2 = clip_pair(static_cast<unsigned>(raw.z), n2);
    const unsigned c3 = clip_pair(static_cast<unsigned>(raw.w), n3);
    esc = (n0 & 1) | ((n0 >> 15) & 2) | ((n1 & 1) << 2) | ((n1 >> 13) & 8) | ((n2 & 1) << 4) |
          ((n2 >> 11) & 32) | ((n3 & 1) << 6) | ((n3 >> 9) & 128);
    return make_uint2(__byte_perm(c0, c1, 0x6420), __byte_perm(c2, c3, 0x6420));
}

// The escapes of one run (bits `esc`, ranks from `rank`), those below kEsc
// written at their rank, their values read again from the run's levels
// `src` (an L2 hit; escapes are rare, and the run's registers are free).
__device__ __forceinline__ void put_escapes(const int16_t* src, unsigned esc, int rank,
                                            int slot0, int16_t* pos, int16_t* val) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if ((esc >> i) & 1) {
            if (rank < kEsc) {
                pos[rank] = static_cast<int16_t>(slot0 + i);
                val[rank] = src[i];
            }
            ++rank;
        }
    }
}

// K18's work on MB m of image b (mb = b * nmb + m) by its warp: the MB's
// loads in one wave, the clip, lv8, the escapes, over[b] and meta8.  Returns
// the lane's int8 runs (pass A's in `run_a`, pass B's in `run_b`, zero past
// run 49) for K19's pack in the fused kernel.
__device__ __forceinline__ void prepack_mb(
    const int16_t* __restrict__ y, const int16_t* __restrict__ uv,
    const int16_t* __restrict__ y2, const uint8_t* __restrict__ lmode, long long lm_bs,
    const uint8_t* __restrict__ cmode, long long cm_bs, const uint8_t* __restrict__ bpred,
    long long bp_bs, int b, int m, long long mb, int lane, int8_t* __restrict__ lv8,
    uint8_t* __restrict__ meta8, int16_t* __restrict__ esc_pos, int16_t* __restrict__ esc_val,
    uint8_t* __restrict__ over, uint2& run_a, uint2& run_b) {
    // bpred's 16 bytes in one load when every MB's are 16-byte aligned.
    const bool vec_meta =
        ((reinterpret_cast<uintptr_t>(bpred) | static_cast<uintptr_t>(bp_bs)) & 15) == 0;
    const int4 raw_a = *reinterpret_cast<const int4*>(y + mb * 256 + 8 * lane);
    int4 raw_b = make_int4(0, 0, 0, 0);
    if (lane < 16) {
        raw_b = *reinterpret_cast<const int4*>(uv + mb * 128 + 8 * lane);
    } else if (lane < kRunsB) {
        raw_b = *reinterpret_cast<const int4*>(y2 + mb * 16 + 8 * (lane - 16));
    }
    uint4 bp = make_uint4(0, 0, 0, 0);
    unsigned meta = 0;  // vec_meta: lane kRunsB's two mode bytes; else lane j's byte j
    const uint8_t* bp_mb = bpred + b * bp_bs + m * 16;
    if (vec_meta) {
        if (lane == kRunsB) {
            bp = *reinterpret_cast<const uint4*>(bp_mb);
            meta = lmode[b * lm_bs + m] | (cmode[b * cm_bs + m] << 8);
        }
    } else if (lane < kMeta) {
        meta = lane < 16 ? bp_mb[lane] : lane == 16 ? lmode[b * lm_bs + m] : cmode[b * cm_bs + m];
    }

    unsigned esc_a, esc_b;
    run_a = clip_run(raw_a, esc_a);
    run_b = clip_run(raw_b, esc_b);
    int8_t* row = lv8 + mb * kSlots;
    *reinterpret_cast<uint2*>(row + 8 * lane) = run_a;
    if (lane < kRunsB) *reinterpret_cast<uint2*>(row + 256 + 8 * lane) = run_b;

    int16_t* pos = esc_pos + mb * kEsc;
    int16_t* val = esc_val + mb * kEsc;
    if (__ballot_sync(kFull, (esc_a | esc_b) != 0) == 0) {  // no escape: the padding
        if (lane == 0) *reinterpret_cast<uint2*>(pos) = make_uint2(kFull, kFull);
        if (lane == 1) *reinterpret_cast<uint2*>(val) = make_uint2(0, 0);
    } else {
        unsigned total;
        const unsigned base = exclusive_scan(__popc(esc_a) | (__popc(esc_b) << 16), lane, total);
        const int n_a = total & 0xFFFF, n = n_a + (total >> 16);
        put_escapes(y + mb * 256 + 8 * lane, esc_a, base & 0xFFFF, 8 * lane, pos, val);
        put_escapes(lane < 16 ? uv + mb * 128 + 8 * lane : y2 + mb * 16 + 8 * (lane - 16), esc_b,
                    n_a + (base >> 16), 256 + 8 * lane, pos, val);
        if (lane >= n && lane < kEsc) {
            pos[lane] = -1;
            val[lane] = 0;
        }
        if (lane == 0 && n > kEsc) over[b] = 1;
    }

    uint8_t* out = meta8 + mb * kMeta;  // 2-byte aligned
    if (vec_meta) {  // lane j < 9 stores bytes 2j, 2j + 1
        const unsigned w0 = __shfl_sync(kFull, bp.x, kRunsB);
        const unsigned w1 = __shfl_sync(kFull, bp.y, kRunsB);
        const unsigned w2 = __shfl_sync(kFull, bp.z, kRunsB);
        const unsigned w3 = __shfl_sync(kFull, bp.w, kRunsB);
        const unsigned modes = __shfl_sync(kFull, meta, kRunsB);
        if (lane < kMeta / 2) {
            const unsigned w =
                lane < 2 ? w0 : lane < 4 ? w1 : lane < 6 ? w2 : lane < 8 ? w3 : modes;
            reinterpret_cast<uint16_t*>(out)[lane] =
                static_cast<uint16_t>((lane & 1) && lane < 8 ? w >> 16 : w & 0xFFFF);
        }
    } else if (lane < kMeta) {
        out[lane] = static_cast<uint8_t>(meta);
    }
}

// A run's bitmap byte: slot 8r + i (byte i of the run) at bit 7 - i.
__device__ __forceinline__ unsigned nonzero_bits(uint2 run) {
    const unsigned x = (__vcmpne4(run.x, 0) & 0x10204080u) | (__vcmpne4(run.y, 0) & 0x01020408u);
    return (x | (x >> 8) | (x >> 16) | (x >> 24)) & 0xFF;
}

// The nonzeros of one run (bitmap byte `bits`, ranks from `rank`), those
// below cap written to the tile at their rank.
__device__ __forceinline__ void put_values(uint2 run, unsigned bits, int rank, int cap,
                                           uint8_t* tile) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if ((bits >> (7 - i)) & 1) {
            const unsigned word = i < 4 ? run.x : run.y;
            if (rank < cap) tile[rank] = static_cast<uint8_t>((word >> (8 * (i & 3))) & 0xFF);
            ++rank;
        }
    }
}

// K19's work on MB mb of image b by its warp, from the lane's int8 runs:
// the bitmap, the first cap nonzeros through the warp's tile (16-byte
// aligned, kTile bytes) and over[b].
__device__ __forceinline__ void pack_mb(uint2 run_a, uint2 run_b, int b, long long mb, int lane,
                                       int cap, uint8_t* __restrict__ bitmap,
                                       int8_t* __restrict__ vals, uint8_t* __restrict__ over,
                                       uint8_t* tile) {
    const unsigned bits_a = nonzero_bits(run_a), bits_b = nonzero_bits(run_b);
    uint8_t* bm = bitmap + mb * kBitmap;
    bm[lane] = static_cast<uint8_t>(bits_a);
    if (lane < kRunsB) bm[32 + lane] = static_cast<uint8_t>(bits_b);
    unsigned total;
    const unsigned base = exclusive_scan(__popc(bits_a) | (__popc(bits_b) << 16), lane, total);
    const int n_a = total & 0xFFFF, n = n_a + (total >> 16);
    const int chunks = (cap + 15) / 16;
    for (int k = lane; k < chunks; k += 32) {
        reinterpret_cast<uint4*>(tile)[k] = make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
    put_values(run_a, bits_a, base & 0xFFFF, cap, tile);
    put_values(run_b, bits_b, n_a + (base >> 16), cap, tile);
    __syncwarp();
    int8_t* out = vals + mb * cap;
    if (cap % 16 == 0 && (reinterpret_cast<uintptr_t>(vals) & 15) == 0) {
        for (int k = lane; k < cap / 16; k += 32) {
            reinterpret_cast<uint4*>(out)[k] = reinterpret_cast<const uint4*>(tile)[k];
        }
    } else {
        for (int k = lane; k < cap; k += 32) out[k] = static_cast<int8_t>(tile[k]);
    }
    if (lane == 0 && n > cap) over[b] = 1;
}

__global__ void __launch_bounds__(kWarps * 32) prepack_kernel(
    const int16_t* __restrict__ y, const int16_t* __restrict__ uv,
    const int16_t* __restrict__ y2, const uint8_t* __restrict__ lmode, long long lm_bs,
    const uint8_t* __restrict__ cmode, long long cm_bs, const uint8_t* __restrict__ bpred,
    long long bp_bs, int nmb, int8_t* __restrict__ lv8, uint8_t* __restrict__ meta8,
    int16_t* __restrict__ esc_pos, int16_t* __restrict__ esc_val, uint8_t* __restrict__ over) {
    const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y;
    if (m >= nmb) return;  // the whole warp
    uint2 run_a, run_b;
    prepack_mb(y, uv, y2, lmode, lm_bs, cmode, cm_bs, bpred, bp_bs, b, m,
               static_cast<long long>(b) * nmb + m, lane, lv8, meta8, esc_pos, esc_val, over,
               run_a, run_b);
}

__global__ void __launch_bounds__(kWarps * 32) pack_levels_kernel(
    const int8_t* __restrict__ lv8, int nmb, int cap, uint8_t* __restrict__ bitmap,
    int8_t* __restrict__ vals, uint8_t* __restrict__ over) {
    __shared__ __align__(16) uint8_t tiles[kWarps][kTile];
    const int warp = threadIdx.x >> 5;
    const int m = blockIdx.x * kWarps + warp;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y;
    if (m >= nmb) return;
    const long long mb = static_cast<long long>(b) * nmb + m;
    const int8_t* row = lv8 + mb * kSlots;  // 8-byte aligned (the wrapper checks lv8)
    const uint2 run_a = *reinterpret_cast<const uint2*>(row + 8 * lane);
    const uint2 run_b =
        lane < kRunsB ? *reinterpret_cast<const uint2*>(row + 256 + 8 * lane) : make_uint2(0, 0);
    pack_mb(run_a, run_b, b, mb, lane, cap, bitmap, vals, over, tiles[warp]);
}

// K18 then K19 at kCapMb, the runs handed over in registers.
__global__ void __launch_bounds__(kWarps * 32) prepack_pack_kernel(
    const int16_t* __restrict__ y, const int16_t* __restrict__ uv,
    const int16_t* __restrict__ y2, const uint8_t* __restrict__ lmode, long long lm_bs,
    const uint8_t* __restrict__ cmode, long long cm_bs, const uint8_t* __restrict__ bpred,
    long long bp_bs, int nmb, int8_t* __restrict__ lv8, uint8_t* __restrict__ meta8,
    int16_t* __restrict__ esc_pos, int16_t* __restrict__ esc_val, uint8_t* __restrict__ over,
    uint8_t* __restrict__ bitmap, int8_t* __restrict__ vals, uint8_t* __restrict__ sp_over) {
    __shared__ __align__(16) uint8_t tiles[kWarps][kTile];
    const int warp = threadIdx.x >> 5;
    const int m = blockIdx.x * kWarps + warp;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y;
    if (m >= nmb) return;
    const long long mb = static_cast<long long>(b) * nmb + m;
    uint2 run_a, run_b;
    prepack_mb(y, uv, y2, lmode, lm_bs, cmode, cm_bs, bpred, bp_bs, b, m, mb, lane, lv8, meta8,
               esc_pos, esc_val, over, run_a, run_b);
    pack_mb(run_a, run_b, b, mb, lane, kCapMb, bitmap, vals, sp_over, tiles[warp]);
}

// ---- K20 (see the design above) ----

constexpr int kNib = kCapMb / 2;                 // nibble bytes an MB
constexpr int kWireMbs = 32;                     // MBs a K20 CTA
constexpr int kMbsPerWarp = kWireMbs / kWarps;
constexpr int kListBytes = 6 * kEscImg;          // the image list: i32 positions, i16 values
constexpr int kListPer = 4;                      // MBs a thread of a list CTA loads a round
constexpr int kListMbs = kWarps * 32 * kListPer;  // MBs a list CTA ranks a round
constexpr int kRegions = 5;
static_assert(kMbsPerWarp % 2 == 0, "one scan ranks a pair of a warp's MBs in 16-bit halves");

// A CTA's pieces of the row, staged: each 16 bytes longer than its bytes.
struct WireStage {
    uint8_t bitmap[kWireMbs * kBitmap + 16];
    uint8_t nib[kWireMbs * kNib + 16];
    uint8_t med_idx[kWireMbs * kMedCap + 16];
    uint8_t med_val[kWireMbs * kMedCap + 16];
    uint8_t meta[kWireMbs * kMeta + 16];
};

union WireShared {
    WireStage s;                      // an MB CTA's pieces
    uint8_t list[kListBytes + 16];    // a list CTA's image list, staged
};

// One contiguous piece of the row: where it goes, its staging buffer (the
// byte at dst lies at stage[dst & 15]) and its length.
struct Piece {
    uint8_t* dst;
    uint8_t* stage;
    int bytes;
};

__device__ __forceinline__ int head_of(const uint8_t* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

__device__ __forceinline__ int chunks_of(const Piece& p) { return (head_of(p.dst) + p.bytes + 15) >> 4; }

__device__ __forceinline__ uint8_t* staged(const Piece& p) { return p.stage + head_of(p.dst); }

// Region r of the MBs [m0, m0 + n) of the image row w (nmb MBs).
__device__ __forceinline__ Piece region(int r, uint8_t* w, long long nmb, int m0, int n,
                                        WireStage& s) {
    uint8_t* base = w + 2;
    switch (r) {
    case 0: return {base + static_cast<long long>(m0) * kBitmap, s.bitmap, n * kBitmap};
    case 1: return {base + nmb * kBitmap + static_cast<long long>(m0) * kNib, s.nib, n * kNib};
    case 2:
        return {base + nmb * (kBitmap + kNib) + static_cast<long long>(m0) * kMedCap, s.med_idx,
                n * kMedCap};
    case 3:
        return {base + nmb * (kBitmap + kNib + kMedCap) + static_cast<long long>(m0) * kMedCap,
                s.med_val, n * kMedCap};
    default:
        return {base + nmb * (kBitmap + kNib + 2 * kMedCap) + static_cast<long long>(m0) * kMeta,
                s.meta, n * kMeta};
    }
}

// Bytes [lo, hi) of the 16-byte-aligned chunk g from its staged copy s,
// in the widest aligned stores that fit.
__device__ __forceinline__ void store_part(uint8_t* g, const uint8_t* s, int lo, int hi) {
    while (lo < hi) {
        if ((lo & 7) == 0 && lo + 8 <= hi) {
            *reinterpret_cast<uint2*>(g + lo) = *reinterpret_cast<const uint2*>(s + lo);
            lo += 8;
        } else if ((lo & 3) == 0 && lo + 4 <= hi) {
            *reinterpret_cast<unsigned*>(g + lo) = *reinterpret_cast<const unsigned*>(s + lo);
            lo += 4;
        } else if ((lo & 1) == 0 && lo + 2 <= hi) {
            *reinterpret_cast<uint16_t*>(g + lo) = *reinterpret_cast<const uint16_t*>(s + lo);
            lo += 2;
        } else {
            g[lo] = s[lo];
            lo += 1;
        }
    }
}

// Chunk k of piece p: a uint4 store where the chunk lies wholly inside the
// piece, else its part of the chunk, so that no byte outside the piece is
// written (the neighbouring CTA's, or the next image's).
__device__ __forceinline__ void copy_chunk(const Piece& p, int k) {
    const int head = head_of(p.dst);
    uint8_t* g = p.dst - head + 16 * k;
    const uint8_t* s = p.stage + 16 * k;
    const int lo = k == 0 ? head : 0;
    const int hi = min(16, head + p.bytes - 16 * k);
    if (lo == 0 && hi == 16) {
        *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    } else {
        store_part(g, s, lo, hi);
    }
}

// A 2-byte-aligned 32-bit store into a staging buffer.
__device__ __forceinline__ void st_stage32(uint8_t* p, unsigned v) {
    if (reinterpret_cast<uintptr_t>(p) & 3) {
        reinterpret_cast<uint16_t*>(p)[0] = static_cast<uint16_t>(v);
        reinterpret_cast<uint16_t*>(p)[1] = static_cast<uint16_t>(v >> 16);
    } else {
        *reinterpret_cast<unsigned*>(p) = v;
    }
}

// A run of 8 int8 values -> its 4 nibble bytes (low nibble: the even slot).
__device__ __forceinline__ unsigned nibbles(uint2 run) {
    const unsigned a = run.x & 0x0F0F0F0Fu, b = run.y & 0x0F0F0F0Fu;
    return __byte_perm(a | (a >> 4), b | (b >> 4), 0x6420);
}

// A run's |v| > 7 slots: bit i for byte i (-128 included).
__device__ __forceinline__ unsigned med_bits(uint2 run) {
    const unsigned a = __vcmpgtu4(__vabsss4(run.x), 0x07070707u);
    const unsigned b = __vcmpgtu4(__vabsss4(run.y), 0x07070707u);
    const unsigned x = (a & 0x08040201u) | (b & 0x80402010u);
    return (x | (x >> 8) | (x >> 16) | (x >> 24)) & 0xFF;
}

// The med entries of one run (bits, ranks from `rank`), those below
// kMedCap written to the staged idx / val tiles of their MB.
__device__ __forceinline__ void put_med(uint2 run, unsigned bits, int rank, int slot0, uint8_t* mi,
                                        uint8_t* mv) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if ((bits >> i) & 1) {
            if (rank < kMedCap) {
                const unsigned word = i < 4 ? run.x : run.y;
                mi[rank] = static_cast<uint8_t>(slot0 + i);
                mv[rank] = static_cast<uint8_t>(word >> (8 * (i & 3)));
            }
            ++rank;
        }
    }
}

// Live escapes (position >= 0) of an MB's 4 int16 positions.
__device__ __forceinline__ int live_escapes(uint2 pos) {
    return kEsc - __popc((pos.x & 0x80008000u) | ((pos.y & 0x80008000u) >> 1));
}

// Exclusive scan of x over the CTA; `total` gets the sum of all.  `sums`
// holds a word a warp; the caller syncs before it is written again.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned x, int lane, int warp,
                                                         unsigned* sums, unsigned& total) {
    unsigned warp_total;
    const unsigned ex = exclusive_scan(x, lane, warp_total);
    if (lane == 0) sums[warp] = warp_total;
    __syncthreads();
    unsigned before = 0;
    total = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
        const unsigned t = sums[q];
        before += q < warp ? t : 0;
        total += t;
    }
    return before + ex;
}

// K20's list CTA for image b: rounds of kListMbs MBs, a thread kListPer
// consecutive ones, their positions and values in one wave of 8-byte
// loads, ranks by the live mask from one block scan, the entries below
// kEscImg into the zeroed staged tile (no round once the list is over its
// cap); the list out in 16-byte chunks; the overflow flag byte.
__device__ __forceinline__ void wire_list(const int16_t* __restrict__ esc_pos,
                                          const int16_t* __restrict__ esc_val,
                                          const uint8_t* __restrict__ overflow, int nmb, int b,
                                          uint8_t* w, uint8_t* stage, unsigned* sums) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    uint8_t* lst = w + 2 + static_cast<long long>(nmb) * (kBitmap + kNib + 2 * kMedCap + kMeta);
    const Piece lp = {lst, stage, kListBytes};
    uint8_t* tile = staged(lp);
    for (int q = tid; q < (kListBytes + 16) / 16; q += kWarps * 32) {
        reinterpret_cast<uint4*>(stage)[q] = make_uint4(0, 0, 0, 0);
    }
    const long long img = static_cast<long long>(b) * nmb;
    int carry = 0;
    for (int r0 = 0; r0 < nmb && carry <= kEscImg; r0 += kListMbs) {
        const int m1 = r0 + tid * kListPer;
        uint2 p[kListPer], v[kListPer];
#pragma unroll
        for (int q = 0; q < kListPer; ++q) {
            p[q] = make_uint2(kFull, kFull);
            v[q] = make_uint2(0, 0);
            if (m1 + q < nmb) {
                p[q] = *reinterpret_cast<const uint2*>(esc_pos + (img + m1 + q) * kEsc);
                v[q] = *reinterpret_cast<const uint2*>(esc_val + (img + m1 + q) * kEsc);
            }
        }
        int n = 0;
#pragma unroll
        for (int q = 0; q < kListPer; ++q) n += live_escapes(p[q]);
        unsigned round_total;
        int rank = carry + static_cast<int>(
            block_exclusive_scan(static_cast<unsigned>(n), lane, warp, sums, round_total));
#pragma unroll
        for (int q = 0; q < kListPer; ++q) {
#pragma unroll
            for (int e = 0; e < kEsc; ++e) {
                const unsigned pw = e < 2 ? p[q].x : p[q].y, vw = e < 2 ? v[q].x : v[q].y;
                const int pe = static_cast<int16_t>(pw >> (16 * (e & 1)));
                if (pe >= 0) {
                    if (rank < kEscImg) {
                        st_stage32(tile + 4 * rank, static_cast<unsigned>((m1 + q) * kSlots + pe));
                        reinterpret_cast<uint16_t*>(tile + 4 * kEscImg)[rank] =
                            static_cast<uint16_t>(vw >> (16 * (e & 1)));
                    }
                    ++rank;
                }
            }
        }
        carry += static_cast<int>(round_total);
        __syncthreads();  // sums is rewritten next round
    }
    for (int q = tid; q < chunks_of(lp); q += kWarps * 32) copy_chunk(lp, q);
    if (tid == 0) w[1] = overflow[b] || carry > kEscImg;
}

// K20, CTA (x, b) of a grid (1 + ceil(nmb / 32), B).  x = 0 writes image
// b's list and its overflow flag byte (`wire_list`: it needs only the
// inputs, so it runs beside the MB CTAs, and is dispatched first); x = c +
// 1 writes the row pieces of MBs [32c, 32c + 32) and adds 1 (| 1 << 32
// where one of its MBs' med lists is over kMedCap) to the image's word in
// `tickets`.  The CTA that brings the count to the number of MB CTAs
// writes the sp_over flag byte and zeroes the word: the med flags travel
// in that one atomic word, so no fence orders the CTAs.
__global__ void __launch_bounds__(kWarps * 32) wire_kernel(
    const uint8_t* __restrict__ bitmap, const int8_t* __restrict__ vals,
    const uint8_t* __restrict__ meta8, const int16_t* __restrict__ esc_pos,
    const int16_t* __restrict__ esc_val, const uint8_t* __restrict__ sp_over,
    const uint8_t* __restrict__ overflow, int nmb, long long row,
    unsigned long long* __restrict__ tickets, uint8_t* __restrict__ wire) {
    __shared__ __align__(16) WireShared sh;
    __shared__ unsigned cta_med, sums[kWarps];
    const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    uint8_t* w = wire + b * row;
    if (blockIdx.x == 0) {
        wire_list(esc_pos, esc_val, overflow, nmb, b, w, sh.list, sums);
        return;
    }
    const int n_cta = gridDim.x - 1, m0 = (blockIdx.x - 1) * kWireMbs;
    const int n_mbs = min(kWireMbs, nmb - m0);

    // 1. Every load of the warp's MBs before any is used: a run of 8
    //    values a lane, the bitmap and meta8 two bytes a lane.
    uint2 run[kMbsPerWarp];
    unsigned bm[kMbsPerWarp], mt[kMbsPerWarp];
#pragma unroll
    for (int h = 0; h < kMbsPerWarp; ++h) {
        const int j = warp * kMbsPerWarp + h;
        run[h] = make_uint2(0, 0);
        bm[h] = mt[h] = 0;
        if (j < n_mbs) {
            const long long mb = static_cast<long long>(b) * nmb + m0 + j;
            run[h] = *reinterpret_cast<const uint2*>(vals + mb * kCapMb + 8 * lane);
            if (lane < kBitmap / 2) bm[h] = reinterpret_cast<const uint16_t*>(bitmap + mb * kBitmap)[lane];
            if (lane < kMeta / 2) mt[h] = reinterpret_cast<const uint16_t*>(meta8 + mb * kMeta)[lane];
        }
    }

    // 2. Zeroed med tiles (the lists' padding).
    for (int k = tid; k < 2 * (kWireMbs * kMedCap + 16) / 16; k += kWarps * 32) {
        reinterpret_cast<uint4*>(sh.s.med_idx)[k] = make_uint4(0, 0, 0, 0);
    }
    if (tid == 0) cta_med = 0;
    __syncthreads();

    // 3. Stage the pieces: nibbles a word a lane, bitmap and meta8 two bytes
    //    a lane, the med entries at their ranks from one scan of both MBs'
    //    counts (16-bit halves).
    uint8_t* s_bm = staged(region(0, w, nmb, m0, n_mbs, sh.s));
    uint8_t* s_nib = staged(region(1, w, nmb, m0, n_mbs, sh.s));
    uint8_t* s_mi = staged(region(2, w, nmb, m0, n_mbs, sh.s));
    uint8_t* s_mv = staged(region(3, w, nmb, m0, n_mbs, sh.s));
    uint8_t* s_mt = staged(region(4, w, nmb, m0, n_mbs, sh.s));
    unsigned hot[kMbsPerWarp];
#pragma unroll
    for (int h = 0; h < kMbsPerWarp; ++h) hot[h] = med_bits(run[h]);  // 0 past the image's MBs
#pragma unroll
    for (int h = 0; h < kMbsPerWarp; ++h) {
        const int j = warp * kMbsPerWarp + h;
        if (j < n_mbs) {
            st_stage32(s_nib + j * kNib + 4 * lane, nibbles(run[h]));
            if (lane < kBitmap / 2) reinterpret_cast<uint16_t*>(s_bm + j * kBitmap)[lane] = bm[h];
            if (lane < kMeta / 2) reinterpret_cast<uint16_t*>(s_mt + j * kMeta)[lane] = mt[h];
        }
    }
    bool over_cap = false;
#pragma unroll
    for (int h = 0; h < kMbsPerWarp; h += 2) {  // one scan a pair of MBs
        unsigned total;
        const unsigned base =
            exclusive_scan(__popc(hot[h]) | (__popc(hot[h + 1]) << 16), lane, total);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int j = warp * kMbsPerWarp + h + i;
            if (j < n_mbs) {
                put_med(run[h + i], hot[h + i], (base >> (16 * i)) & 0xFFFF, 8 * lane,
                        s_mi + j * kMedCap, s_mv + j * kMedCap);
            }
        }
        over_cap |= (total & 0xFFFF) > kMedCap || (total >> 16) > kMedCap;
    }
    if (lane == 0 && over_cap) cta_med = 1;
    __syncthreads();

    // 4. Take the image's ticket (its latency under the copy-out), and copy
    //    the pieces out, their chunks dealt over the CTA's threads; the
    //    image's last MB CTA writes the sp_over flag byte.
    unsigned long long* word = tickets + b;
    unsigned long long add = 0, old = 0;
    if (tid == 0) {
        add = 1ull | (static_cast<unsigned long long>(cta_med) << 32);
        old = atomicAdd(word, add);
    }
    int k = tid;  // the thread's chunk, counted over the pieces in row order
#pragma unroll
    for (int r = 0; r < kRegions; ++r) {
        const Piece p = region(r, w, nmb, m0, n_mbs, sh.s);
        const int n = chunks_of(p);
        for (; k < n; k += kWarps * 32) copy_chunk(p, k);
        k -= n;
    }
    if (tid == 0) {
        const unsigned long long seen = old + add;
        if (static_cast<unsigned>(seen) == static_cast<unsigned>(n_cta)) {
            w[0] = sp_over[b] || (seen >> 32);
            *word = 0;
        }
    }
}

dim3 mb_grid(int nmb, int batch) { return dim3((nmb + kWarps - 1) / kWarps, batch); }

}  // namespace

// K18.  y, uv, y2 int16 levels 16-byte aligned; lv8 int8 [B, nmb, 400]
// (8-byte aligned), meta8 uint8 [B, nmb, 18], esc_pos / esc_val int16 [B,
// nmb, 4] (8-byte aligned) out; over bool [B] zeroed by the caller.
WEBP_API int webp_prepack(const void* y, const void* uv, const void* y2, const void* lmode,
                          long long lm_bs, const void* cmode, long long cm_bs, const void* bpred,
                          long long bp_bs, int nmb, int batch, void* lv8, void* meta8,
                          void* esc_pos, void* esc_val, void* over, void* stream) {
    if (nmb <= 0 || batch <= 0) return 0;
    prepack_kernel<<<mb_grid(nmb, batch), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(y), static_cast<const int16_t*>(uv),
        static_cast<const int16_t*>(y2), static_cast<const uint8_t*>(lmode), lm_bs,
        static_cast<const uint8_t*>(cmode), cm_bs, static_cast<const uint8_t*>(bpred), bp_bs, nmb,
        static_cast<int8_t*>(lv8), static_cast<uint8_t*>(meta8), static_cast<int16_t*>(esc_pos),
        static_cast<int16_t*>(esc_val), static_cast<uint8_t*>(over));
    return static_cast<int>(cudaGetLastError());
}

// K19.  lv8 int8 [B, nmb, 400] 8-byte aligned; bitmap uint8 [B, nmb * 50],
// vals int8 [B, nmb, cap] (cap in 1..400) out; over bool [B] zeroed by the
// caller.
WEBP_API int webp_pack_levels(const void* lv8, int nmb, int batch, int cap, void* bitmap,
                              void* vals, void* over, void* stream) {
    if (nmb <= 0 || batch <= 0) return 0;
    pack_levels_kernel<<<mb_grid(nmb, batch), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(lv8), nmb, cap, static_cast<uint8_t*>(bitmap),
        static_cast<int8_t*>(vals), static_cast<uint8_t*>(over));
    return static_cast<int>(cudaGetLastError());
}

// K18 + K19 at CAP_MB: K18's arguments and outputs, then K19's bitmap
// uint8 [B, nmb * 50], vals int8 [B, nmb, 256] and sp_over bool [B]
// (zeroed by the caller).
WEBP_API int webp_prepack_pack(const void* y, const void* uv, const void* y2, const void* lmode,
                               long long lm_bs, const void* cmode, long long cm_bs,
                               const void* bpred, long long bp_bs, int nmb, int batch, void* lv8,
                               void* meta8, void* esc_pos, void* esc_val, void* over,
                               void* bitmap, void* vals, void* sp_over, void* stream) {
    if (nmb <= 0 || batch <= 0) return 0;
    prepack_pack_kernel<<<mb_grid(nmb, batch), kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(y), static_cast<const int16_t*>(uv),
        static_cast<const int16_t*>(y2), static_cast<const uint8_t*>(lmode), lm_bs,
        static_cast<const uint8_t*>(cmode), cm_bs, static_cast<const uint8_t*>(bpred), bp_bs, nmb,
        static_cast<int8_t*>(lv8), static_cast<uint8_t*>(meta8), static_cast<int16_t*>(esc_pos),
        static_cast<int16_t*>(esc_val), static_cast<uint8_t*>(over),
        static_cast<uint8_t*>(bitmap), static_cast<int8_t*>(vals),
        static_cast<uint8_t*>(sp_over));
    return static_cast<int>(cudaGetLastError());
}

// K20, one launch.  wire uint8 [B, 2 + 260 * nmb + 3072] out; tickets
// uint64 [B], zero before the call and left zero; bitmap and meta8 2-byte
// aligned, vals, esc_pos and esc_val 8-byte aligned.
WEBP_API int webp_wire(const void* bitmap, const void* vals, const void* meta8,
                       const void* esc_pos, const void* esc_val, const void* sp_over,
                       const void* overflow, int nmb, int batch, void* tickets, void* wire,
                       void* stream) {
    if (nmb <= 0 || batch <= 0) return 0;
    const long long row = 2 + static_cast<long long>(nmb) *
                                  (kBitmap + kNib + 2 * kMedCap + kMeta) + kListBytes;
    wire_kernel<<<dim3(1 + (nmb + kWireMbs - 1) / kWireMbs, batch), kWarps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bitmap), static_cast<const int8_t*>(vals),
        static_cast<const uint8_t*>(meta8), static_cast<const int16_t*>(esc_pos),
        static_cast<const int16_t*>(esc_val), static_cast<const uint8_t*>(sp_over),
        static_cast<const uint8_t*>(overflow), nmb, row,
        static_cast<unsigned long long*>(tickets), static_cast<uint8_t*>(wire));
    return static_cast<int>(cudaGetLastError());
}
