// Kernels K21 pack_flat and K22 expand_flat: the image-flat sparse level
// format (a bitmap of the nonzero slots, MSB first as np.packbits, and the
// nonzero values of the whole image in slot order).
//
// K21 replaces webp_tpu/ops/sparse.py:42 device_pack_levels, a cumsum of the
// mask and a searchsorted per output value: vals[k] is the (k+1)-th nonzero
// of the image, 0 past the image's count; nonzeros past `cap` are dropped
// and overflow = count > cap.  K22 replaces :110 device_expand_levels, a
// cumsum and a take_along_axis: a set slot of image-wide rank r takes
// vals[min(r, cap - 1)] (past the cap the last value repeats), an unset
// slot 0, and only the first n bits count.
//
// A slot's rank is image-wide (up to 614,400 slots an image at 768x512), so
// it crosses blocks.  K21: each thread owns one bitmap byte, 8 slots; a
// block of 256 threads owns a tile of 2,048 slots.  Three launches: the
// tile counts; one block per image scans them (exclusive, in place) and
// sets the overflow flag; the tile pass ranks each slot by the tile's offset
// plus a block scan of the threads' popcounts plus the set bits before it in
// its byte.  A thread builds its byte itself, slot j at bit 7 - j, so no
// ballot needs reversing.  K22 is one launch (below): a thread per 32 slots,
// the tile offsets by a decoupled look-back.  Offsets into the batch are
// 64-bit; a rank inside one image fits int32.  Integers only.
//
// Bound: K21 memory: it reads N and writes N/8 + cap bytes an image.  K22
// reads N/8 + (the values it uses) and writes n bytes, and ranks every
// slot: at 6 integer operations a slot the operations bound it.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;             // a CTA (K21: a bitmap byte, 8 slots, each)
constexpr int kScanThreads = 1024;

// Exclusive prefix of `v` over a block of kN threads; *total gets the
// block's sum.  warp_sums: kN / 32 ints of shared memory.
template <int kN>
__device__ int block_exclusive(int v, int* warp_sums, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += o;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kN / 32; ++w) {
        before += w < warp ? warp_sums[w] : 0;
        all += warp_sums[w];
    }
    __syncthreads();  // warp_sums may be rewritten by the caller's next call
    *total = all;
    return before + inc - v;
}

// The mask byte of slots 8t .. 8t+7 of image b's levels, which go to v.
__device__ __forceinline__ unsigned pack_byte(const int8_t* flat, long long N, int b, int t,
                                              int8_t* v) {
    const int8_t* p = flat + b * N + 8LL * t;
    unsigned byte = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        v[j] = p[j];
        byte |= static_cast<unsigned>(v[j] != 0) << (7 - j);
    }
    return byte;
}

// Tile counts of the pack: the nonzero slots of each tile of N slots an image.
__global__ void __launch_bounds__(kThreads) tile_count_kernel(const int8_t* __restrict__ flat,
                                                              long long N, int nbytes, int ntiles,
                                                              int* __restrict__ tiles) {
    __shared__ int warp_sums[kThreads / 32];
    const int b = blockIdx.y, tile = blockIdx.x;
    const int t = tile * kThreads + threadIdx.x;
    int c = 0;
    if (t < nbytes) {
        int8_t v[8];
        c = __popc(pack_byte(flat, N, b, t, v));
    }
    int total;
    block_exclusive<kThreads>(c, warp_sums, &total);
    if (threadIdx.x == 0) tiles[static_cast<long long>(b) * ntiles + tile] = total;
}

// One block per image: the exclusive scan of its tile counts, in place;
// with `over`, over[b] = (the image's count > cap).
__global__ void __launch_bounds__(kScanThreads) tile_scan_kernel(int* __restrict__ tiles,
                                                                 int ntiles, int cap,
                                                                 uint8_t* __restrict__ over) {
    __shared__ int warp_sums[kScanThreads / 32];
    int* row = tiles + static_cast<long long>(blockIdx.x) * ntiles;
    int carry = 0;
    for (int start = 0; start < ntiles; start += kScanThreads) {
        const int i = start + threadIdx.x;
        const int c = i < ntiles ? row[i] : 0;
        int total;
        const int ex = block_exclusive<kScanThreads>(c, warp_sums, &total);
        if (i < ntiles) row[i] = carry + ex;
        carry += total;
    }
    if (over != nullptr && threadIdx.x == 0) over[blockIdx.x] = carry > cap ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads) pack_flat_kernel(
    const int8_t* __restrict__ flat, long long N, int nbytes, int ntiles, int cap,
    const int* __restrict__ tiles, uint8_t* __restrict__ bitmap, int8_t* __restrict__ vals) {
    __shared__ int warp_sums[kThreads / 32];
    const int b = blockIdx.y, tile = blockIdx.x;
    const int t = tile * kThreads + threadIdx.x;
    int8_t v[8];
    unsigned byte = 0;
    if (t < nbytes) {
        byte = pack_byte(flat, N, b, t, v);
        bitmap[b * (N / 8) + t] = static_cast<uint8_t>(byte);
    }
    int total;
    int r = tiles[static_cast<long long>(b) * ntiles + tile]
            + block_exclusive<kThreads>(__popc(byte), warp_sums, &total);
    int8_t* out = vals + static_cast<long long>(b) * cap;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if ((byte >> (7 - j)) & 1) {
            if (r < cap) out[r] = v[j];
            ++r;
        }
    }
}

// ---- K22: one launch ------------------------------------------------------
//
// A CTA per tile of kTileSlots slots of one image, 32 kWords slots (kWords
// bitmap words) a thread.  The image's CTAs take their tiles by a ticket,
// in order, so a CTA waits only on CTAs that already run; the tile's
// image-wide offset comes from a decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016) over
// one 64-bit status word a tile: its count as an aggregate, then its
// inclusive prefix, flag and value in one store.  The tickets, a done count
// and the status words live in a buffer the kernel leaves zero: each
// image's last CTA to finish resets its words.  Once its offset is known a
// CTA copies the span of values its set slots take into shared memory
// (16-byte loads) and each thread writes its bytes in 16-byte stores; a row
// that does not start and end on 16 bytes goes out through the same shared
// tile, 16-byte stores between byte stores at its head and tail.
constexpr int kWords = 1;
constexpr int kTileSlots = 32 * kWords * kThreads;
constexpr unsigned long long kAggregate = 1ull << 32, kPrefix = 2ull << 32;

struct ExpandShared {
    // The tile's values at their address mod 16, then a misaligned row's
    // bytes (+ 16: the 16-byte copies' and the funnel's overread).
    uint8_t tile_bytes[kTileSlots + 16];
    int warp_sums[kThreads / 32];
    int tile, off;
};

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Slots first .. first + 31 of an image's bitmap row as one word, slot
// first + k at bit 31 - k; slots at or past n are 0.
__device__ __forceinline__ unsigned slot_word(const uint8_t* row, long long nb, long long n,
                                              long long first) {
    if (first >= n) return 0;
    const long long t = first >> 3;  // a multiple of 4
    unsigned w = 0;
    if (t + 3 < nb && (reinterpret_cast<uintptr_t>(row + t) & 3) == 0) {
        w = *reinterpret_cast<const unsigned*>(row + t);
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (t + i < nb) w |= static_cast<unsigned>(row[t + i]) << (8 * i);
        }
    }
    w = __byte_perm(w, 0, 0x0123);  // byte 0 (slots first ..) on top
    const long long valid = n - first;
    return valid < 32 ? w & (0xFFFFFFFFu << (32 - valid)) : w;
}

// Warp 0: publish the tile's count, look back over the statuses before it
// (kLook a lane, 32 * kLook a round: an image of 75 tiles in one round) to
// its exclusive prefix, publish its inclusive prefix.
constexpr int kLook = 4;

__device__ int look_back(unsigned long long* status, int tile, int total, int lane) {
    if (lane == 0) st_relaxed(status + tile, (tile == 0 ? kPrefix : kAggregate) | total);
    if (tile == 0) return 0;
    int excl = 0;
    for (int end = tile;;) {
        unsigned long long s[kLook];
#pragma unroll
        for (int i = 0; i < kLook; ++i) {  // distance 32 i + lane: tile end - 1 - 32 i - lane
            const int j = end - 1 - 32 * i - lane;
            s[i] = j >= 0 ? ld_relaxed(status + j) : kPrefix;  // a prefix of 0 before tile 0
        }
        int stop = 32 * kLook;  // the distance of the nearest prefix
        bool empty = false;     // a status nearer than it not published yet
#pragma unroll
        for (int i = kLook - 1; i >= 0; --i) {
            const unsigned prefix = __ballot_sync(0xffffffffu, (s[i] >> 32) == 2);
            if (prefix) stop = 32 * i + __ffs(prefix) - 1;
        }
#pragma unroll
        for (int i = 0; i < kLook; ++i) {
            empty |= __any_sync(0xffffffffu, (s[i] >> 32) == 0 && 32 * i + lane < stop);
        }
        if (empty) continue;  // read the round again
        int v = 0;
#pragma unroll
        for (int i = 0; i < kLook; ++i) {
            v += 32 * i + lane <= stop ? static_cast<int>(static_cast<unsigned>(s[i])) : 0;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (stop < 32 * kLook) break;
        end -= 32 * kLook;
    }
    if (lane == 0) st_relaxed(status + tile, kPrefix | (excl + total));
    return excl;
}

__global__ void __launch_bounds__(kThreads, 8) expand_flat_kernel(
    const uint8_t* __restrict__ bitmap, long long nb, const int8_t* __restrict__ vals, int cap,
    long long n, int ntiles, unsigned long long* __restrict__ state, int8_t* __restrict__ out) {
    __shared__ __align__(16) ExpandShared sh;
    const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    unsigned long long* head = state + b;  // tickets (low 32 bits), CTAs done (high 32)
    unsigned long long* status = state + gridDim.y + static_cast<long long>(b) * ntiles;
    const uint8_t* row = bitmap + b * nb;

    // 1. The ticket (the tile), the tile's bitmap words, the block scan.
    if (tid == 0) sh.tile = static_cast<int>(static_cast<unsigned>(atomicAdd(head, 1ull)));
    __syncthreads();
    const int tile = sh.tile;
    const long long first = static_cast<long long>(tile) * kTileSlots;  // the tile's first slot
    unsigned bits[kWords];
    int c = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
        bits[i] = slot_word(row, nb, n, first + 32 * (kWords * tid + i));
        c += __popc(bits[i]);
    }
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += up;
    }
    if (lane == 31) sh.warp_sums[warp] = inc;
    __syncthreads();
    int before = inc - c, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
        before += w < warp ? sh.warp_sums[w] : 0;
        total += sh.warp_sums[w];
    }

    // 2. The tile's offset in the image.
    if (warp == 0) {
        const int excl = look_back(status, tile, total, lane);
        if (lane == 0) sh.off = excl;
    }
    __syncthreads();
    const int off = sh.off;

    // 3. The values of ranks off .. off + total - 1 (each at most cap - 1),
    //    staged at their address mod 16.
    const int8_t* vrow = vals + static_cast<long long>(b) * cap;
    const int lo = min(off, cap - 1);
    const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(vrow + lo) & 15);
    if (total > 0) {
        const int span = lead + min(off + total - 1, cap - 1) - lo + 1;  // staged bytes
        const int8_t* a0 = vrow + lo - lead;                             // 16-byte aligned
        for (int k = tid; k < (span + 15) / 16; k += kThreads) {
            if (16 * k >= lead && 16 * k + 16 <= span) {
                *reinterpret_cast<uint4*>(sh.tile_bytes + 16 * k) =
                    __ldg(reinterpret_cast<const uint4*>(a0 + 16 * k));
            } else {
                for (int i = max(16 * k, lead); i < min(16 * k + 16, span); ++i) {
                    sh.tile_bytes[i] = static_cast<uint8_t>(a0[i]);
                }
            }
        }
    }
    __syncthreads();

    // 4. The thread's bytes: slot k takes the value of its rank if set.
    uint32_t w[8 * kWords];
    int r = off + before;
    const int base = lead - lo;
#pragma unroll
    for (int k = 0; k < 32 * kWords; ++k) {
        const unsigned bit = (bits[k >> 5] >> (31 - (k & 31))) & 1;
        const uint32_t v = bit ? sh.tile_bytes[min(r, cap - 1) + base] : 0;
        r += static_cast<int>(bit);
        w[k >> 2] = (k & 3 ? w[k >> 2] : 0) | v << (8 * (k & 3));
    }
    int8_t* dst = out + b * n + first;
    const int len = static_cast<int>(min(static_cast<long long>(kTileSlots), n - first));
    const int mine = 32 * kWords * tid;  // the thread's first byte in the tile
    if ((reinterpret_cast<uintptr_t>(out + b * n) & 15) == 0 && n % 16 == 0) {
#pragma unroll
        for (int h = 0; h < 2 * kWords; ++h) {
            if (mine + 16 * h < len) {
                *reinterpret_cast<uint4*>(dst + mine + 16 * h) =
                    make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
            }
        }
    } else {  // through the shared tile: bytes to the first aligned address, then 16 at a time
        __syncthreads();  // every thread has read its values
#pragma unroll
        for (int h = 0; h < 2 * kWords; ++h) {
            *reinterpret_cast<uint4*>(sh.tile_bytes + mine + 16 * h) =
                make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
        }
        __syncthreads();
        const int head_bytes =
            min(len, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
        const int chunks = (len - head_bytes) / 16;
        const int shift = 8 * (head_bytes & 3);
        for (int k = tid; k < chunks; k += kThreads) {
            const uint32_t* in =
                reinterpret_cast<const uint32_t*>(sh.tile_bytes + ((head_bytes + 16 * k) & ~3));
            uint32_t x[5];
#pragma unroll
            for (int i = 0; i < 5; ++i) x[i] = in[i];
            *reinterpret_cast<uint4*>(dst + head_bytes + 16 * k) =
                make_uint4(__funnelshift_r(x[0], x[1], shift), __funnelshift_r(x[1], x[2], shift),
                           __funnelshift_r(x[2], x[3], shift), __funnelshift_r(x[3], x[4], shift));
        }
        const int tail = head_bytes + 16 * chunks;
        if (tid < head_bytes) dst[tid] = static_cast<int8_t>(sh.tile_bytes[tid]);
        if (tid < len - tail) dst[tail + tid] = static_cast<int8_t>(sh.tile_bytes[tail + tid]);
    }

    // 5. Done: the image's last CTA resets its tickets and status words.
    if (warp == 0) {
        unsigned long long done = 0;
        if (lane == 0) {
            __threadfence();
            done = atomicAdd(head, 1ull << 32) >> 32;
            __threadfence();
        }
        if (__shfl_sync(0xffffffffu, done, 0) == static_cast<unsigned long long>(ntiles - 1)) {
            __threadfence();
            for (int j = lane; j < ntiles; j += 32) status[j] = 0;
            if (lane == 0) *head = 0;
        }
    }
}

int tiles_of(long long nbytes) { return static_cast<int>((nbytes + kThreads - 1) / kThreads); }

}  // namespace

// K21.  flat int8 [B, N] (N % 8 == 0, N < 2^31); bitmap uint8 [B, N/8],
// vals int8 [B, cap] (zeroed by the caller: the pad past the count), over
// bool [B] out; tiles int32 [B, ceil(N / 2048)] scratch.
WEBP_API int webp_pack_flat(const void* flat, long long N, int batch, int cap, void* tiles,
                            void* bitmap, void* vals, void* over, void* stream) {
    if (N <= 0 || batch <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const int nbytes = static_cast<int>(N / 8), ntiles = tiles_of(nbytes);
    const dim3 grid(ntiles, batch);
    const auto* f = static_cast<const int8_t*>(flat);
    int* tl = static_cast<int*>(tiles);
    tile_count_kernel<<<grid, kThreads, 0, s>>>(f, N, nbytes, ntiles, tl);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_scan_kernel<<<batch, kScanThreads, 0, s>>>(tl, ntiles, cap, static_cast<uint8_t*>(over));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    pack_flat_kernel<<<grid, kThreads, 0, s>>>(f, N, nbytes, ntiles, cap, tl,
                                               static_cast<uint8_t*>(bitmap),
                                               static_cast<int8_t*>(vals));
    return static_cast<int>(cudaGetLastError());
}

// K22, one launch.  bitmap uint8 [B, nb], vals int8 [B, cap] (cap >= 1),
// n <= 8 * nb (n < 2^31); out int8 [B, n]; state uint64 [B + B * ceil(n /
// kTileSlots)], zero before the call and left zero.
WEBP_API int webp_expand_flat(const void* bitmap, long long nb, const void* vals, int cap,
                              long long n, int batch, void* state, void* out, void* stream) {
    if (n <= 0 || batch <= 0) return 0;
    const int ntiles = static_cast<int>((n + kTileSlots - 1) / kTileSlots);
    expand_flat_kernel<<<dim3(ntiles, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bitmap), nb, static_cast<const int8_t*>(vals), cap, n, ntiles,
        static_cast<unsigned long long*>(state), static_cast<int8_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
