// Shared helpers of the decode and encode kernels.  Every entry point is a
// plain C function: device pointers and the stream arrive as void*, batch strides
// as long long (elements), and the return value is the cudaGetLastError()
// of the launch, which the Python wrapper turns into an exception.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WEBP_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// One 4-byte asynchronous copy from global to shared memory (sm_80+),
// complete for this thread after a cp_async_wait that covers its group.
static __device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src) : "memory");
}

// One 16-byte asynchronous copy from global to shared memory, both 16-byte
// aligned, bypassing L1 (data read once).
static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src) : "memory");
}

static __device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
static __device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory"); }

// ---- Transforms and intra predictors shared by K1, K2 and K5 ----

static constexpr int kC1 = 20091;
static constexpr int kC2 = 35468;

// Exact (a * c) >> 16 (arithmetic shift, i.e. floor), formed in 64 bits.
static __device__ __forceinline__ int mul16(int a, int c) {
    return static_cast<int>((static_cast<long long>(a) * c) >> 16);
}

// RFC 6386 14.3 inverse DCT of one block, in place.
static __device__ void idct4x4(int* b) {
    int t[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // columns: rows r0..r3 of column i
        const int r0 = b[i], r1 = b[4 + i], r2 = b[8 + i], r3 = b[12 + i];
        const int a1 = r0 + r2, b1 = r0 - r2;
        const int c1 = mul16(r1, kC2) - (r3 + mul16(r3, kC1));
        const int d1 = (r1 + mul16(r1, kC1)) + mul16(r3, kC2);
        t[i] = a1 + d1;
        t[4 + i] = b1 + c1;
        t[8 + i] = b1 - c1;
        t[12 + i] = a1 - d1;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // rows
        const int c0 = t[4 * r], c1 = t[4 * r + 1], c2 = t[4 * r + 2], c3 = t[4 * r + 3];
        const int a1 = c0 + c2, b1 = c0 - c2;
        const int cc = mul16(c1, kC2) - (c3 + mul16(c3, kC1));
        const int dd = (c1 + mul16(c1, kC1)) + mul16(c3, kC2);
        b[4 * r] = (a1 + dd + 4) >> 3;
        b[4 * r + 1] = (b1 + cc + 4) >> 3;
        b[4 * r + 2] = (b1 - cc + 4) >> 3;
        b[4 * r + 3] = (a1 - dd + 4) >> 3;
    }
}

// Inverse WHT of the Y2 block `in` -> 16 Y DCs `out`.
static __device__ void iwht4x4(const int* in, int* out) {
    int t[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r0 = in[i], r1 = in[4 + i], r2 = in[8 + i], r3 = in[12 + i];
        t[i] = (r0 + r3) + (r1 + r2);
        t[4 + i] = (r1 - r2) + (r0 - r3);
        t[8 + i] = (r0 + r3) - (r1 + r2);
        t[12 + i] = (r0 - r3) - (r1 - r2);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int c0 = t[4 * r], c1 = t[4 * r + 1], c2 = t[4 * r + 2], c3 = t[4 * r + 3];
        const int a1 = c0 + c3, b1 = c1 + c2, c1n = c1 - c2, d1 = c0 - c3;
        out[4 * r] = (a1 + b1 + 3) >> 3;
        out[4 * r + 1] = (c1n + d1 + 3) >> 3;
        out[4 * r + 2] = (a1 - b1 + 3) >> 3;
        out[4 * r + 3] = (d1 - c1n + 3) >> 3;
    }
}

// Pixel of a plane with VP8's frame borders: the row above the frame is
// 127 (its corner included), the column left of it 129.
static __device__ __forceinline__ int pix(const uint8_t* p, int stride, int row, int col) {
    if (row < 0) return 127;
    if (col < 0) return 129;
    return p[row * stride + col];
}

static __device__ __forceinline__ int avg2(int a, int b) { return (a + b + 1) >> 1; }
static __device__ __forceinline__ int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }

// The ten 4x4 B-mode predictors (RFC 6386 12.3, webp_tpu/ops/predict.py
// predict_b).  e[0..3] = left pixels bottom-up (L3 L2 L1 L0), e[4] = the
// top-left corner, e[5..12] = the eight pixels above (A0..A7, A4..A7 being
// above-right).  out[r*4 + c].
static __device__ void predict_b4(int mode, const int* e, int* out) {
    const int L0 = e[3], L1 = e[2], L2 = e[1], L3 = e[0], P = e[4];
    const int* A = e + 5;
    switch (mode) {
    case 0: {  // B_DC
        int v = 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) v += A[i] + e[3 - i];
#pragma unroll
        for (int i = 0; i < 16; ++i) out[i] = v >> 3;
        break;
    }
    case 1:  // B_TM
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) out[r * 4 + c] = clip255(e[3 - r] + A[c] - P);
        break;
    case 2: {  // B_VE
        const int row[4] = {avg3(P, A[0], A[1]), avg3(A[0], A[1], A[2]),
                            avg3(A[1], A[2], A[3]), avg3(A[2], A[3], A[4])};
#pragma unroll
        for (int i = 0; i < 16; ++i) out[i] = row[i & 3];
        break;
    }
    case 3: {  // B_HE
        const int col[4] = {avg3(P, L0, L1), avg3(L0, L1, L2), avg3(L1, L2, L3), avg3(L2, L3, L3)};
#pragma unroll
        for (int i = 0; i < 16; ++i) out[i] = col[i >> 2];
        break;
    }
    case 4: {  // B_LD
        int avgs[7];
#pragma unroll
        for (int i = 0; i < 7; ++i) avgs[i] = avg3(A[i], A[i + 1], A[i + 2 < 7 ? i + 2 : 7]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) out[r * 4 + c] = avgs[r + c];
        break;
    }
    case 5: {  // B_RD
        int avgs[7];
#pragma unroll
        for (int i = 0; i < 7; ++i) avgs[i] = avg3(e[i], e[i + 1], e[i + 2]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) out[r * 4 + c] = avgs[3 - r + c];
        break;
    }
    case 6:  // B_VR
        out[12] = avg3(e[1], e[2], e[3]);
        out[8] = avg3(e[2], e[3], e[4]);
        out[13] = out[4] = avg3(e[3], e[4], e[5]);
        out[9] = out[0] = avg2(e[4], e[5]);
        out[14] = out[5] = avg3(e[4], e[5], e[6]);
        out[10] = out[1] = avg2(e[5], e[6]);
        out[15] = out[6] = avg3(e[5], e[6], e[7]);
        out[11] = out[2] = avg2(e[6], e[7]);
        out[7] = avg3(e[6], e[7], e[8]);
        out[3] = avg2(e[7], e[8]);
        break;
    case 7:  // B_VL
        out[0] = avg2(A[0], A[1]);
        out[4] = avg3(A[0], A[1], A[2]);
        out[8] = out[1] = avg2(A[1], A[2]);
        out[5] = out[12] = avg3(A[1], A[2], A[3]);
        out[9] = out[2] = avg2(A[2], A[3]);
        out[13] = out[6] = avg3(A[2], A[3], A[4]);
        out[10] = out[3] = avg2(A[3], A[4]);
        out[14] = out[7] = avg3(A[3], A[4], A[5]);
        out[11] = avg3(A[4], A[5], A[6]);
        out[15] = avg3(A[5], A[6], A[7]);
        break;
    case 8:  // B_HD
        out[12] = avg2(e[0], e[1]);
        out[13] = avg3(e[0], e[1], e[2]);
        out[8] = out[14] = avg2(e[1], e[2]);
        out[9] = out[15] = avg3(e[1], e[2], e[3]);
        out[10] = out[4] = avg2(e[2], e[3]);
        out[11] = out[5] = avg3(e[2], e[3], e[4]);
        out[6] = out[0] = avg2(e[3], e[4]);
        out[7] = out[1] = avg3(e[3], e[4], e[5]);
        out[2] = avg3(e[4], e[5], e[6]);
        out[3] = avg3(e[5], e[6], e[7]);
        break;
    default:  // 9: B_HU
        out[0] = avg2(L0, L1);
        out[1] = avg3(L0, L1, L2);
        out[2] = out[4] = avg2(L1, L2);
        out[3] = out[5] = avg3(L1, L2, L3);
        out[6] = out[8] = avg2(L2, L3);
        out[7] = out[9] = avg3(L2, L3, L3);
        out[10] = out[11] = L3;
        out[12] = out[13] = out[14] = out[15] = L3;
        break;
    }
}

// Whole-block DC/V/H/TM prediction of pixel (r, c) of an n x n block whose
// top-left pixel is (row0, col0); `dc` is precomputed by the caller.
static __device__ __forceinline__ int predict_whole(int mode, const uint8_t* p, int stride,
                                                    int row0, int col0, int r, int c, int dc) {
    switch (mode) {
    case 0: return dc;
    case 1: return pix(p, stride, row0 - 1, col0 + c);
    case 2: return pix(p, stride, row0 + r, col0 - 1);
    default:
        return clip255(pix(p, stride, row0 + r, col0 - 1) + pix(p, stride, row0 - 1, col0 + c)
                       - pix(p, stride, row0 - 1, col0 - 1));
    }
}

// DC of an n x n block: the rounded mean of the neighbours that exist, 128
// at the frame's top-left MB.
static __device__ int whole_dc(const uint8_t* p, int stride, int row0, int col0, int n, int log2n) {
    const bool above = row0 > 0, left = col0 > 0;
    if (!above && !left) return 128;
    int total = 0;
    for (int i = 0; i < n; ++i) {
        if (above) total += p[(row0 - 1) * stride + col0 + i];
        if (left) total += p[(row0 + i) * stride + col0 - 1];
    }
    const int shf = log2n - 1 + above + left;
    return (total + (1 << (shf - 1))) >> shf;
}
