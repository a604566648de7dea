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
// Design of K20: its per-MB part walks its MB's 256 values 32 at a time,
// __ballot_sync + __popc of the lower lanes giving each med entry its rank
// in slot order.  Per-image flags are single byte stores of 1 into buffers
// the caller zeroed (every writer stores the same value).  K20's image list
// is a second kernel, one block per image, that ranks the nmb * kEsc escape
// slots with a block-wide scan of warp ballots, in (MB, k) order, and then
// writes the row's two flag bytes.  The list starts at 2 + 260 * nmb, which
// is 2 mod 4: every multi-byte value is stored byte by byte.

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
constexpr int kListThreads = 256; // threads of the image-list block
constexpr int kRunsB = kSlots / 8 - 32;  // runs of pass B: 32..49
constexpr int kTile = kSlots;     // bytes of a warp's vals tile (cap <= 400)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

__device__ __forceinline__ void store_le(uint8_t* p, int v, int n) {
    for (int i = 0; i < n; ++i) p[i] = static_cast<uint8_t>((v >> (8 * i)) & 0xFF);
}

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

// K20, per MB: the row's bitmap, nibbles, med list and meta8 of MB m; an
// image's med_over[b] = 1 when one of its MBs lists more than kMedCap.
__global__ void __launch_bounds__(kWarps * 32) wire_mb_kernel(
    const uint8_t* __restrict__ bitmap, const int8_t* __restrict__ vals,
    const uint8_t* __restrict__ meta8, int nmb, long long row, uint8_t* __restrict__ wire,
    int* __restrict__ med_over) {
    const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y;
    if (m >= nmb) return;
    const long long mb = static_cast<long long>(b) * nmb + m;
    const long long n = nmb;
    uint8_t* w = wire + b * row;
    for (int j = lane; j < kBitmap; j += 32) w[2 + m * kBitmap + j] = bitmap[mb * kBitmap + j];
    const int8_t* v = vals + mb * kCapMb;
    uint8_t* v4 = w + 2 + n * kBitmap + m * (kCapMb / 2);
    for (int j = lane; j < kCapMb / 2; j += 32) {
        v4[j] = static_cast<uint8_t>((v[2 * j] & 0xF) | ((v[2 * j + 1] & 0xF) << 4));
    }
    uint8_t* mi = w + 2 + n * (kBitmap + kCapMb / 2) + m * kMedCap;
    uint8_t* mv = mi + n * kMedCap;
    int count = 0;
    for (int base = 0; base < kCapMb; base += 32) {
        const int k = base + lane;
        const int x = v[k];
        const bool hot = abs(x) > 7;
        const unsigned bal = __ballot_sync(0xffffffffu, hot);
        if (hot) {
            const int r = count + __popc(bal & lanes_below(lane));
            if (r < kMedCap) {
                mi[r] = static_cast<uint8_t>(k);
                mv[r] = static_cast<uint8_t>(x & 0xFF);
            }
        }
        count += __popc(bal);
    }
    for (int r = count + lane; r < kMedCap; r += 32) mi[r] = mv[r] = 0;
    if (lane == 0 && count > kMedCap) med_over[b] = 1;
    if (lane < kMeta) w[2 + n * (kBitmap + kCapMb / 2 + 2 * kMedCap) + m * kMeta + lane] =
        meta8[mb * kMeta + lane];
}

// K20, per image: the escape list from the per-MB pairs, then the flags.
__global__ void __launch_bounds__(kListThreads) wire_list_kernel(
    const int16_t* __restrict__ esc_pos, const int16_t* __restrict__ esc_val,
    const uint8_t* __restrict__ sp_over, const uint8_t* __restrict__ overflow,
    const int* __restrict__ med_over, int nmb, long long row, uint8_t* __restrict__ wire) {
    __shared__ int warp_count[kListThreads / 32];
    const int b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    uint8_t* w = wire + b * row;
    uint8_t* eg_pos = w + 2 + static_cast<long long>(nmb) * (kBitmap + kCapMb / 2 + 2 * kMedCap + kMeta);
    uint8_t* eg_val = eg_pos + 4 * kEscImg;
    const long long n = static_cast<long long>(nmb) * kEsc;
    const int16_t* pos = esc_pos + b * n;
    const int16_t* val = esc_val + b * n;
    int total = 0;  // the same in every thread
    for (long long start = 0; start < n && total <= kEscImg; start += kListThreads) {
        const long long i = start + tid;
        const int p = i < n ? pos[i] : -1;
        const bool live = p >= 0;
        const unsigned bal = __ballot_sync(0xffffffffu, live);
        if (lane == 0) warp_count[warp] = __popc(bal);
        __syncthreads();
        int before = 0, all = 0;
        for (int q = 0; q < kListThreads / 32; ++q) {
            before += q < warp ? warp_count[q] : 0;
            all += warp_count[q];
        }
        const int r = total + before + __popc(bal & lanes_below(lane));
        if (live && r < kEscImg) {
            const long long g = (i / kEsc) * kSlots + p;  // below 2^31 for nmb < 5.3e6
            store_le(eg_pos + 4 * r, static_cast<int>(g), 4);
            store_le(eg_val + 2 * r, val[i], 2);
        }
        total += all;
        __syncthreads();  // warp_count is rewritten next pass
    }
    for (int r = total + tid; r < kEscImg; r += kListThreads) {
        store_le(eg_pos + 4 * r, 0, 4);
        store_le(eg_val + 2 * r, 0, 2);
    }
    if (tid == 0) {
        w[0] = (sp_over[b] || med_over[b]) ? 1 : 0;
        w[1] = (overflow[b] || total > kEscImg) ? 1 : 0;
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

// K20: the per-MB kernel, then the image-list kernel on the same stream.
// wire uint8 [B, 2 + 260 * nmb + 3072] out; med_over int32 [B] zeroed by
// the caller (scratch).
WEBP_API int webp_wire(const void* bitmap, const void* vals, const void* meta8,
                       const void* esc_pos, const void* esc_val, const void* sp_over,
                       const void* overflow, int nmb, int batch, void* med_over, void* wire,
                       void* stream) {
    if (nmb <= 0 || batch <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const long long row = 2 + static_cast<long long>(nmb) *
                                  (kBitmap + kCapMb / 2 + 2 * kMedCap + kMeta) + 6 * kEscImg;
    wire_mb_kernel<<<mb_grid(nmb, batch), kWarps * 32, 0, s>>>(
        static_cast<const uint8_t*>(bitmap), static_cast<const int8_t*>(vals),
        static_cast<const uint8_t*>(meta8), nmb, row, static_cast<uint8_t*>(wire),
        static_cast<int*>(med_over));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    wire_list_kernel<<<batch, kListThreads, 0, s>>>(
        static_cast<const int16_t*>(esc_pos), static_cast<const int16_t*>(esc_val),
        static_cast<const uint8_t*>(sp_over), static_cast<const uint8_t*>(overflow),
        static_cast<const int*>(med_over), nmb, row, static_cast<uint8_t*>(wire));
    return static_cast<int>(cudaGetLastError());
}
