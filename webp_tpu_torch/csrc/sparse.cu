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
// Design: a slot's rank is image-wide (up to 614,400 slots an image at
// 768x512), so it crosses blocks.  Each thread owns one bitmap byte, 8
// slots; a block of 256 threads owns a tile of 2,048 slots.  Three
// launches: the tile counts; one block per image scans them (exclusive,
// in place) and, for the pack, sets the overflow flag; the tile pass ranks
// each slot by the tile's offset plus a block scan of the threads' popcounts
// plus the set bits before it in its byte.  A thread builds its byte itself,
// slot j at bit 7 - j, so no ballot needs reversing.  Offsets into the batch
// are 64-bit; a rank inside one image fits int32.  Integers only.
//
// Bound: memory.  The pack reads N and writes N/8 + cap bytes an image, the
// expand reads N/8 + (the values it uses) and writes n; the scans move
// 4 bytes a tile.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;             // bitmap bytes (of 8 slots) a tile
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

// Bitmap byte t of image b, cut to the first n bits.
__device__ __forceinline__ unsigned expand_byte(const uint8_t* bitmap, long long nb, long long n,
                                                int b, int t) {
    const long long first = 8LL * t;
    if (first >= n) return 0;
    unsigned byte = bitmap[b * nb + t];
    const long long valid = n - first;
    if (valid < 8) byte &= (0xFFu << (8 - valid)) & 0xFFu;
    return byte;
}

// Tile counts.  pack: flat != null (N slots an image); expand: the bitmap's
// first n bits (nb bytes an image).
__global__ void __launch_bounds__(kThreads) tile_count_kernel(
    const int8_t* __restrict__ flat, long long N, const uint8_t* __restrict__ bitmap,
    long long nb, long long n, int nbytes, int ntiles, int* __restrict__ tiles) {
    __shared__ int warp_sums[kThreads / 32];
    const int b = blockIdx.y, tile = blockIdx.x;
    const int t = tile * kThreads + threadIdx.x;
    int c = 0;
    if (t < nbytes) {
        int8_t v[8];
        c = __popc(flat ? pack_byte(flat, N, b, t, v) : expand_byte(bitmap, nb, n, b, t));
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

__global__ void __launch_bounds__(kThreads) expand_flat_kernel(
    const uint8_t* __restrict__ bitmap, long long nb, const int8_t* __restrict__ vals, int cap,
    long long n, int nbytes, int ntiles, const int* __restrict__ tiles, int8_t* __restrict__ out) {
    __shared__ int warp_sums[kThreads / 32];
    const int b = blockIdx.y, tile = blockIdx.x;
    const int t = tile * kThreads + threadIdx.x;
    const unsigned byte = t < nbytes ? expand_byte(bitmap, nb, n, b, t) : 0;
    int total;
    int r = tiles[static_cast<long long>(b) * ntiles + tile]
            + block_exclusive<kThreads>(__popc(byte), warp_sums, &total);
    if (t >= nbytes) return;
    const int8_t* v = vals + static_cast<long long>(b) * cap;
    int8_t* o = out + b * n;
    const long long first = 8LL * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (first + j >= n) break;
        int8_t x = 0;
        if ((byte >> (7 - j)) & 1) {
            x = v[min(r, cap - 1)];
            ++r;
        }
        o[first + j] = x;
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
    tile_count_kernel<<<grid, kThreads, 0, s>>>(f, N, nullptr, 0, 0, nbytes, ntiles, tl);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_scan_kernel<<<batch, kScanThreads, 0, s>>>(tl, ntiles, cap, static_cast<uint8_t*>(over));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    pack_flat_kernel<<<grid, kThreads, 0, s>>>(f, N, nbytes, ntiles, cap, tl,
                                               static_cast<uint8_t*>(bitmap),
                                               static_cast<int8_t*>(vals));
    return static_cast<int>(cudaGetLastError());
}

// K22.  bitmap uint8 [B, nb], vals int8 [B, cap] (cap >= 1), n <= 8 * nb
// (n < 2^31); out int8 [B, n]; tiles int32 [B, ceil(ceil(n / 8) / 256)]
// scratch.
WEBP_API int webp_expand_flat(const void* bitmap, long long nb, const void* vals, int cap,
                              long long n, int batch, void* tiles, void* out, void* stream) {
    if (n <= 0 || batch <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const int nbytes = static_cast<int>((n + 7) / 8), ntiles = tiles_of(nbytes);
    const dim3 grid(ntiles, batch);
    const auto* bm = static_cast<const uint8_t*>(bitmap);
    int* tl = static_cast<int*>(tiles);
    tile_count_kernel<<<grid, kThreads, 0, s>>>(nullptr, 0, bm, nb, n, nbytes, ntiles, tl);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_scan_kernel<<<batch, kScanThreads, 0, s>>>(tl, ntiles, 0, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    expand_flat_kernel<<<grid, kThreads, 0, s>>>(bm, nb, static_cast<const int8_t*>(vals), cap, n,
                                                 nbytes, ntiles, tl, static_cast<int8_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
