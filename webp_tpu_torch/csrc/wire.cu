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
// K20 replaces encode_wavefront2.py:1200 _wire_stage (with :1178
// _rank_compact, :1149 _i16_le_bytes): one uint8 row per image holding the
// flags, the bitmap, the int4 nibbles of the packed values, the per-MB list
// of the |v| > 7 slots, meta8 and the image list of the escapes.  The JAX
// form compacts both lists with float32 one-hot matmuls, which round the
// positions mb * 400 + pos once they pass 2^24; here every rank is an
// integer (ADVICE r5).
//
// Design: integer arithmetic only.  K18, K19 and K20's per-MB part run one
// warp per MB (8 warps a block, a grid of (MB chunks, images)); a warp walks
// its MB's slots 32 at a time, and __ballot_sync + __popc of the lower
// lanes give each slot its rank in slot order.  Per-image flags are single
// byte stores of 1 into buffers the caller zeroed (every writer stores the
// same value).  K20's image list is a second kernel, one block per image,
// that ranks the nmb * kEsc escape slots with a block-wide scan of warp
// ballots, in (MB, k) order, and then writes the row's two flag bytes.
// The list starts at 2 + 260 * nmb, which is 2 mod 4: every multi-byte
// value is stored byte by byte.
//
// Bound: memory.  K18 reads 818 B and writes 400 + 18 + 16 B per MB, K19
// reads 400 and writes 50 + 256, K20 reads 50 + 256 + 18 + 16 and writes
// 260 B per MB; the ballots and popcounts are a few integer operations a
// slot.

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

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

__device__ __forceinline__ void store_le(uint8_t* p, int v, int n) {
    for (int i = 0; i < n; ++i) p[i] = static_cast<uint8_t>((v >> (8 * i)) & 0xFF);
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
    const long long mb = static_cast<long long>(b) * nmb + m;
    int n_esc = 0;
    for (int base = 0; base < kSlots; base += 32) {
        const int s = base + lane;
        int v = 0;
        if (s < kSlots) {
            v = s < 256 ? y[mb * 256 + s] : s < 384 ? uv[mb * 128 + s - 256] : y2[mb * 16 + s - 384];
            lv8[mb * kSlots + s] = static_cast<int8_t>(max(-128, min(127, v)));
        }
        const bool esc = abs(v) > 127;
        const unsigned bal = __ballot_sync(0xffffffffu, esc);
        if (esc) {
            const int r = n_esc + __popc(bal & lanes_below(lane));
            if (r < kEsc) {
                esc_pos[mb * kEsc + r] = static_cast<int16_t>(s);
                esc_val[mb * kEsc + r] = static_cast<int16_t>(v);
            }
        }
        n_esc += __popc(bal);
    }
    if (lane >= n_esc && lane < kEsc) {
        esc_pos[mb * kEsc + lane] = -1;
        esc_val[mb * kEsc + lane] = 0;
    }
    if (lane == 0 && n_esc > kEsc) over[b] = 1;
    if (lane < kMeta) {
        meta8[mb * kMeta + lane] = lane < 16 ? bpred[b * bp_bs + m * 16 + lane]
                                 : lane == 16 ? lmode[b * lm_bs + m] : cmode[b * cm_bs + m];
    }
}

__global__ void __launch_bounds__(kWarps * 32) pack_levels_kernel(
    const int8_t* __restrict__ lv8, int nmb, int cap, uint8_t* __restrict__ bitmap,
    int8_t* __restrict__ vals, uint8_t* __restrict__ over) {
    const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.y;
    if (m >= nmb) return;
    const long long mb = static_cast<long long>(b) * nmb + m;
    int count = 0;
    for (int base = 0; base < kSlots; base += 32) {
        const int s = base + lane;
        const int v = s < kSlots ? lv8[mb * kSlots + s] : 0;
        const unsigned bal = __ballot_sync(0xffffffffu, v != 0);
        if (v != 0) {
            const int r = count + __popc(bal & lanes_below(lane));
            if (r < cap) vals[mb * cap + r] = static_cast<int8_t>(v);
        }
        // Lane j < 4 writes byte j of this pass: slots base + 8j .. +7, MSB
        // first.  The ballot holds slot base + i at bit i; reversed, at 31 - i.
        const int byte = base / 8 + lane;
        if (lane < 4 && byte < kBitmap) {
            bitmap[mb * kBitmap + byte] = static_cast<uint8_t>((__brev(bal) >> (24 - 8 * lane)) & 0xFF);
        }
        count += __popc(bal);
    }
    for (int k = count + lane; k < cap; k += 32) vals[mb * cap + k] = 0;
    if (lane == 0 && count > cap) over[b] = 1;
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

// K18.  lv8 int8 [B, nmb, 400], meta8 uint8 [B, nmb, 18], esc_pos / esc_val
// int16 [B, nmb, 4] out; over bool [B] zeroed by the caller.
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

// K19.  bitmap uint8 [B, nmb * 50], vals int8 [B, nmb, cap] out; over bool
// [B] zeroed by the caller.
WEBP_API int webp_pack_levels(const void* lv8, int nmb, int batch, int cap, void* bitmap,
                              void* vals, void* over, void* stream) {
    if (nmb <= 0 || batch <= 0) return 0;
    pack_levels_kernel<<<mb_grid(nmb, batch), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(lv8), nmb, cap, static_cast<uint8_t*>(bitmap),
        static_cast<int8_t*>(vals), static_cast<uint8_t*>(over));
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
