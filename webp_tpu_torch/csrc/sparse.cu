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
// it crosses blocks.  Each kernel is one launch over tiles of kTileSlots
// slots of one image, 32 a thread, which the image's CTAs take by a ticket,
// in order, so a CTA waits only on tiles that running CTAs hold; a tile's
// image-wide offset comes from a decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016) over
// one 64-bit status word a tile: its count as an aggregate, then its
// inclusive prefix, flag and value in one store.  The tickets, a done count
// and the status words live in a buffer the kernels leave zero, reset at
// the end by one CTA of each image.  Offsets into the batch are 64-bit; a
// rank inside one image fits int32.  Integers only.
//
// K21: a few CTAs an image (as many as fit on the card at once, up to one
// a ticket), each taking tickets until they run out.  A tile's thread reads
// its 32 levels once (two 16-byte loads where its row allows, narrower on a
// misaligned row), builds their 32 bitmap bits in a register and stores
// them as one 4-byte word (bytes where the bitmap row is not 4-byte
// aligned); the CTA publishes its count and takes its next ticket, stages
// its nonzeros in a shared tile at their rank in the tile (no offset
// needed), issues the next tile's loads, then looks back, and the staged
// run goes to vals in 16-byte stores between byte heads and tails
// (`store_span`).  The pad past the image's count (up to cap bytes: more
// than one SM writes quickly) is split into `pads` parts, the tickets after
// the last tile's: a part waits for the last tile's inclusive prefix, the
// image's count, and writes its share of the zeros; the first also writes
// the overflow flag.  The CTA that takes the last part resets the state
// once the image's other CTAs are done.  A CTA waits only on tickets taken
// before its own, so the launch cannot deadlock, and every byte of the
// outputs is written once a call.
// K22: a CTA per tile.  Once its offset is known it copies the span of
// values its set slots take into shared memory (16-byte loads) and each
// thread writes its bytes in 16-byte stores; a row that does not start and
// end on 16 bytes goes out through the same shared tile and `store_span`;
// the image's last CTA to finish resets its words.
//
// Bound: K21 memory: it reads N and writes N/8 + cap + 1 bytes an image.  K22
// reads N/8 + (the values it uses) and writes n bytes, and ranks every
// slot: at 6 integer operations a slot the operations bound it.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileSlots = 32 * kThreads;
constexpr unsigned long long kAggregate = 1ull << 32, kPrefix = 2ull << 32;

struct TileShared {
    // K21: the tile's nonzeros at their rank in the tile.  K22: the tile's
    // values at their address mod 16, then a misaligned row's bytes.  + 16:
    // the 16-byte copies' and the funnel's overread.
    uint8_t tile_bytes[kTileSlots + 16];
    int warp_sums[kThreads / 32];
    int tile, off, count;
};

// Exclusive prefix of `v` over the CTA's threads; *total gets the CTA's sum.
// warp_sums is read after one barrier: the caller writes it only after another.
__device__ __forceinline__ int block_exclusive(int v, int* warp_sums, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += o;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    int before = inc - v, all = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
        before += w < warp ? warp_sums[w] : 0;
        all += warp_sums[w];
    }
    *total = all;
    return before;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

// The CTA's tile: the next ticket of its image (`head`'s low 32 bits).
__device__ __forceinline__ int take_ticket(unsigned long long* head, int* slot) {
    if (threadIdx.x == 0) *slot = static_cast<int>(static_cast<unsigned>(atomicAdd(head, 1ull)));
    __syncthreads();
    return *slot;
}

// The tile's count, published (tile 0's as its inclusive prefix).
__device__ __forceinline__ void publish(unsigned long long* status, int tile, int total) {
    st_relaxed(status + tile, (tile == 0 ? kPrefix : kAggregate) | total);
}

// Warp 0, after `publish`: look back over the statuses before the tile
// (kLook a lane, 32 * kLook a round: an image of 75 tiles in one round) to
// its exclusive prefix, publish its inclusive prefix.
constexpr int kLook = 4;

__device__ int look_back(unsigned long long* status, int tile, int total, int lane) {
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

// K22's warp 0, after the CTA's last read of the statuses: count the CTA
// done; the image's last CTA to finish resets its ticket, done count and
// status words.  Thread 0 wrote the CTA's statuses; the count is an
// acquire-release add, so every CTA's status stores come before the
// reset's.
__device__ void finish(unsigned long long* head, unsigned long long* status, int ntiles,
                       int lane) {
    unsigned long long done = 0;
    if (lane == 0) {
        asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
                     : "=l"(done) : "l"(head), "l"(1ull << 32) : "memory");
        done >>= 32;
    }
    if (__shfl_sync(0xffffffffu, done, 0) == static_cast<unsigned long long>(ntiles - 1)) {
        for (int j = lane; j < ntiles; j += 32) status[j] = 0;
        if (lane == 0) *head = 0;
    }
}

// Bytes 0 .. len - 1 of the shared `tile` (or zeros, kZero) to dst, by
// CTA `part` of `parts`: byte stores up to dst's first 16-byte boundary and
// past its last (part 0), 16-byte stores between, kThreads a round, the
// parts' rounds interleaved; each a chunk of the tile read as 4-byte words
// and funnel-shifted onto dst's lattice (the tile readable 4 bytes past len).
template <bool kZero>
__device__ void store_span(int8_t* dst, const uint8_t* tile, int len, int tid, int part = 0,
                           int parts = 1) {
    const int head =
        min(len, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
    const int chunks = (len - head) / 16;
    const int shift = 8 * (head & 3);
    for (int k = part * kThreads + tid; k < chunks; k += parts * kThreads) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if constexpr (!kZero) {
            const uint32_t* in =
                reinterpret_cast<const uint32_t*>(tile + ((head + 16 * k) & ~3));
            uint32_t x[5];
#pragma unroll
            for (int i = 0; i < 5; ++i) x[i] = in[i];
            v = make_uint4(__funnelshift_r(x[0], x[1], shift), __funnelshift_r(x[1], x[2], shift),
                           __funnelshift_r(x[2], x[3], shift), __funnelshift_r(x[3], x[4], shift));
        }
        *reinterpret_cast<uint4*>(dst + head + 16 * k) = v;
    }
    const int tail = head + 16 * chunks;
    if (part != 0) return;
    if constexpr (kZero) {
        if (tid < head) dst[tid] = 0;
        if (tid < len - tail) dst[tail + tid] = 0;
    } else {
        if (tid < head) dst[tid] = static_cast<int8_t>(tile[tid]);
        if (tid < len - tail) dst[tail + tid] = static_cast<int8_t>(tile[tail + tid]);
    }
}

// ---- K21: one launch ------------------------------------------------------

// The 8 levels at p (p's alignment is its row's: a multiple of 8 apart).
__device__ __forceinline__ uint2 load8(const int8_t* p) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if ((a & 7) == 0) return __ldg(reinterpret_cast<const uint2*>(p));
    if ((a & 3) == 0) {
        const unsigned* q = reinterpret_cast<const unsigned*>(p);
        return make_uint2(__ldg(q), __ldg(q + 1));
    }
    unsigned w[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        w[i >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(p + i))) << (8 * (i & 3));
    }
    return make_uint2(w[0], w[1]);
}

// Slot k of the 32 in w (word k / 4, byte k % 4) at bit 31 - k, set where
// its level is nonzero: np.packbits's bytes of the 32 slots, read big-endian.
__device__ __forceinline__ unsigned nonzero_bits(const unsigned (&w)[8]) {
    unsigned lsb = 0;  // slot k at bit k
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // byte j's 0x01 of the compare to bit j of a nibble
        lsb |= (((__vcmpne4(w[i], 0) & 0x01010101u) * 0x01020408u) >> 24) << (4 * i);
    }
    return __brev(lsb);
}

// K21's thread 0, at the end of a CTA that did not take the image's last
// item: count it done, without waiting (a release add: the CTA's status
// stores come before it).
__device__ __forceinline__ void count_done(unsigned long long* head) {
    asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(head), "l"(1ull << 32)
                 : "memory");
}

// K21's warp 0 of the CTA that took the image's last item: once the
// `others` are done, reset the image's ticket, done count and status words.
__device__ void reset_when_done(unsigned long long* head, unsigned long long* status,
                                int others, int ntiles, int lane) {
    if (lane == 0) {
        while ((ld_acquire(head) >> 32) != static_cast<unsigned long long>(others)) __nanosleep(64);
    }
    __syncwarp();
    for (int j = lane; j < ntiles; j += 32) status[j] = 0;
    if (lane == 0) *head = 0;
}

// The value of a status once it is an inclusive prefix.
__device__ int wait_prefix(const unsigned long long* status) {
    unsigned long long s;
    while (((s = ld_relaxed(status)) >> 32) != 2) __nanosleep(64);
    return static_cast<int>(static_cast<unsigned>(s));
}

// The thread's slots of `tile` in an image's row of N levels: 0, 8, 16, 24
// or 32 (N % 8 == 0).
__device__ __forceinline__ int valid_slots(long long N, int tile, int tid) {
    const long long first = static_cast<long long>(tile) * kTileSlots + 32 * tid;
    return static_cast<int>(max(0LL, min(32LL, N - first)));
}

// The thread's levels of `tile` into w (0 past the row): two 16-byte loads
// where the row allows, else 8, 4 or 1 bytes at a time.
__device__ __forceinline__ void load_slots(const int8_t* row, long long N, int tile, int tid,
                                           unsigned (&w)[8]) {
    const int valid = valid_slots(N, tile, tid);
    const int8_t* src = row + static_cast<long long>(tile) * kTileSlots + 32 * tid;
    if (valid == 32 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const uint4 lo = __ldg(reinterpret_cast<const uint4*>(src));
        const uint4 hi = __ldg(reinterpret_cast<const uint4*>(src) + 1);
        w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
        w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
        return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        uint2 v = make_uint2(0, 0);
        if (8 * c < valid) v = load8(src + 8 * c);
        w[2 * c] = v.x, w[2 * c + 1] = v.y;
    }
}

// gridDim.x CTAs an image, each taking the image's tickets until they run
// out: ticket t < ntiles is tile t, the next `pads` are the pad's parts.
__global__ void __launch_bounds__(kThreads, 6) pack_flat_kernel(
    const int8_t* __restrict__ flat, long long N, int ntiles, int pads, int cap,
    unsigned long long* __restrict__ state, uint8_t* __restrict__ bitmap,
    int8_t* __restrict__ vals, uint8_t* __restrict__ over) {
    __shared__ __align__(16) TileShared sh;
    const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int items = ntiles + pads;
    unsigned long long* head = state + b;  // tickets (low 32 bits), done (high 32)
    unsigned long long* status = state + gridDim.y + static_cast<long long>(b) * ntiles;
    const int8_t* row = flat + b * N;
    uint8_t* brow = bitmap + b * (N / 8);
    int8_t* vrow = vals + static_cast<long long>(b) * cap;

    int item = take_ticket(head, &sh.tile);
    unsigned w[8];
    if (item < ntiles) load_slots(row, N, item, tid, w);
    bool last = false;  // the CTA took the image's last item
    while (item < items) {
        if (item >= ntiles) {  // a part of the pad: the zeros past the image's count
            if (tid == 0) sh.count = wait_prefix(status + ntiles - 1);  // the last tile's
            __syncthreads();
            const int count = sh.count, part = item - ntiles;
            if (part == 0 && tid == 0) over[b] = count > cap ? 1 : 0;
            if (count < cap) store_span<true>(vrow + count, nullptr, cap - count, tid, part, pads);
            last = item == items - 1;
            item = take_ticket(head, &sh.tile);  // past the tiles: a part of the pad or none
            continue;
        }
        // 1. The next ticket asked for (none if the image has a CTA a
        //    ticket); the tile's bitmap word a thread, the block scan.
        unsigned long long ticket = items;
        if (tid == 0 && gridDim.x < items) ticket = atomicAdd(head, 1ull);
        const int valid = valid_slots(N, item, tid);
        const unsigned bits = nonzero_bits(w);
        uint8_t* bdst = brow + (static_cast<long long>(item) * kTileSlots + 32 * tid) / 8;
        const unsigned word = __byte_perm(bits, 0, 0x0123);  // its bytes in memory order
        if (valid == 32 && (reinterpret_cast<uintptr_t>(bdst) & 3) == 0) {
            *reinterpret_cast<unsigned*>(bdst) = word;
        } else {
            for (int q = 0; q < valid / 8; ++q) bdst[q] = static_cast<uint8_t>(word >> (8 * q));
        }
        int total;
        const int before = block_exclusive(__popc(bits), sh.warp_sums, &total);

        // 2. The tile's count published; the nonzeros staged at their rank
        //    in the tile; the next tile's levels loaded while warp 0 looks
        //    back to this one's offset.
        if (tid == 0) publish(status, item, total);
        int r = before;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
            if ((bits >> (31 - k)) & 1) {
                sh.tile_bytes[r++] = static_cast<uint8_t>(w[k >> 2] >> (8 * (k & 3)));
            }
        }
        if (tid == 0) sh.tile = static_cast<int>(static_cast<unsigned>(ticket));
        __syncthreads();
        const int next = sh.tile;
        if (next < ntiles) load_slots(row, N, next, tid, w);
        if (warp == 0) {
            const int excl = look_back(status, item, total, lane);
            if (lane == 0) sh.off = excl;
        }
        __syncthreads();
        const int off = sh.off;

        // 3. The values of ranks off .. min(off + total, cap) - 1.
        store_span<false>(vrow + min(off, cap), sh.tile_bytes, max(0, min(total, cap - off)),
                          tid);
        item = next;
    }
    if (!last) {
        if (tid == 0) count_done(head);
    } else if (warp == 0) {
        reset_when_done(head, status, gridDim.x - 1, ntiles, lane);
    }
}

// ---- K22: one launch ------------------------------------------------------

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

__global__ void __launch_bounds__(kThreads, 8) expand_flat_kernel(
    const uint8_t* __restrict__ bitmap, long long nb, const int8_t* __restrict__ vals, int cap,
    long long n, int ntiles, unsigned long long* __restrict__ state, int8_t* __restrict__ out) {
    __shared__ __align__(16) TileShared sh;
    const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    unsigned long long* head = state + b;  // tickets (low 32 bits), done (high 32)
    unsigned long long* status = state + gridDim.y + static_cast<long long>(b) * ntiles;
    const uint8_t* row = bitmap + b * nb;

    // 1. The ticket (the tile), the thread's bitmap word, the block scan.
    const int tile = take_ticket(head, &sh.tile);
    const long long first = static_cast<long long>(tile) * kTileSlots;  // the tile's first slot
    const unsigned bits = slot_word(row, nb, n, first + 32 * tid);
    int total;
    const int before = block_exclusive(__popc(bits), sh.warp_sums, &total);

    // 2. The tile's offset in the image.
    if (tid == 0) publish(status, tile, total);
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
    uint32_t w[8];
    int r = off + before;
    const int base = lead - lo;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
        const unsigned bit = (bits >> (31 - k)) & 1;
        const uint32_t v = bit ? sh.tile_bytes[min(r, cap - 1) + base] : 0;
        r += static_cast<int>(bit);
        w[k >> 2] = (k & 3 ? w[k >> 2] : 0) | v << (8 * (k & 3));
    }
    int8_t* dst = out + b * n + first;
    const int len = static_cast<int>(min(static_cast<long long>(kTileSlots), n - first));
    const int mine = 32 * tid;  // the thread's first byte in the tile
    if ((reinterpret_cast<uintptr_t>(out + b * n) & 15) == 0 && n % 16 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (mine + 16 * h < len) {
                *reinterpret_cast<uint4*>(dst + mine + 16 * h) =
                    make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
            }
        }
    } else {  // through the shared tile
        __syncthreads();  // every thread has read its values
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            *reinterpret_cast<uint4*>(sh.tile_bytes + mine + 16 * h) =
                make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
        }
        __syncthreads();
        store_span<false>(dst, sh.tile_bytes, len, tid);
    }
    if (warp == 0) finish(head, status, ntiles, lane);
}

int tiles_of(long long slots) { return static_cast<int>((slots + kTileSlots - 1) / kTileSlots); }

// K21's pad parts an image: one per kPadBytes of cap, 1 to kMaxPads.
constexpr int kPadBytes = 32768, kMaxPads = 8;

int pads_of(int cap) { return min(kMaxPads, max(1, (cap + kPadBytes - 1) / kPadBytes)); }

// K21's CTAs resident on the current device at once (0 if unknown).
int pack_flat_resident() {
    static int resident[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (resident[dev] == 0) {
        int per_sm = 0, sms = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pack_flat_kernel, kThreads, 0)
                != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
            return 0;
        }
        resident[dev] = per_sm * sms;
    }
    return resident[dev];
}

}  // namespace

// K21, one launch.  flat int8 [B, N] (N % 8 == 0, N < 2^31); bitmap uint8
// [B, N/8], vals int8 [B, cap] (cap >= 0), over bool [B] out, every byte
// written; state uint64 [B + B * ceil(N / kTileSlots)], zero before the
// call and left zero.
WEBP_API int webp_pack_flat(const void* flat, long long N, int batch, int cap, void* state,
                            void* bitmap, void* vals, void* over, void* stream) {
    if (N <= 0 || batch <= 0) return 0;
    // CTAs an image: its items (tiles and pad parts), or an even share of
    // the CTAs resident at once if fewer; each loops over its image's tickets.
    const int ntiles = tiles_of(N), pads = pads_of(cap);
    const int ctas = min(ntiles + pads, max(1, pack_flat_resident() / batch));
    pack_flat_kernel<<<dim3(ctas, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(flat), N, ntiles, pads, cap,
        static_cast<unsigned long long*>(state), static_cast<uint8_t*>(bitmap),
        static_cast<int8_t*>(vals), static_cast<uint8_t*>(over));
    return static_cast<int>(cudaGetLastError());
}

// K22, one launch.  bitmap uint8 [B, nb], vals int8 [B, cap] (cap >= 1),
// n <= 8 * nb (n < 2^31); out int8 [B, n]; state uint64 [B + B * ceil(n /
// kTileSlots)], zero before the call and left zero.
WEBP_API int webp_expand_flat(const void* bitmap, long long nb, const void* vals, int cap,
                              long long n, int batch, void* state, void* out, void* stream) {
    if (n <= 0 || batch <= 0) return 0;
    const int ntiles = tiles_of(n);
    expand_flat_kernel<<<dim3(ntiles, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bitmap), nb, static_cast<const int8_t*>(vals), cap, n, ntiles,
        static_cast<unsigned long long*>(state), static_cast<int8_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
