// Kernel K1: coefficient levels -> residual blocks + do_sub flags.
//
// Replaces webp_tpu/ops/sparse.py:129 device_expand_levels_mb (a one-hot
// f32 matmul, there only because gathers are slow on a TPU), the escape
// scatter of webp_tpu/decode/device.py:466 _device_decode_sparse8, and the
// dequant / Y2 IWHT / DC fold / IDCT half of decode/device.py:509
// _decode_core.
//
// Bound: memory.  Per MB it reads 50 bitmap bytes, up to cap_mb value bytes
// and 400 dequant factors (cached: 4 segments per image), and writes 1536
// bytes of int32 residuals; the arithmetic is a few thousand integer ops.
// Design: one 64-thread block per (MB, image).  The MB's 400 levels live
// in shared memory only: the bitmap bytes are expanded with a per-byte
// popcount prefix, escapes are found by a binary search of the image's
// ascending escape list, and the 24 IDCTs stage their output in shared
// memory so the residual store is coalesced.

#include "common.cuh"

namespace {

constexpr int kSlots = 400;
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) residual_kernel(
    const uint8_t* __restrict__ bitmap, const int8_t* __restrict__ vals, int cap,
    const int32_t* __restrict__ esc_pos, const int16_t* __restrict__ esc_val, int n_esc,
    const int16_t* __restrict__ levels, long long lv_stride,
    const int16_t* __restrict__ qtab, long long q_stride,
    const uint8_t* __restrict__ seg, long long seg_bs,
    const uint8_t* __restrict__ lmode, long long lm_bs,
    const uint8_t* __restrict__ skipped, long long skip_bs,
    const uint8_t* __restrict__ non_zero, long long nz_bs,
    int nmb, int32_t* __restrict__ res, uint8_t* __restrict__ do_sub) {
    __shared__ int lv[kSlots];
    __shared__ int cnt[kSlots / 8];
    __shared__ int y2dc[16];
    const int m = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const long long mb = static_cast<long long>(b) * nmb + m;

    if (bitmap != nullptr) {
        // Sparse: byte k of the MB's 50-byte bitmap covers slots 8k..8k+7,
        // MSB first; its values start at the popcount of bytes 0..k-1.
        int byte = 0;
        if (tid < kSlots / 8) {
            byte = bitmap[mb * (kSlots / 8) + tid];
            cnt[tid] = __popc(byte);
        }
        __syncthreads();
        if (tid < kSlots / 8) {
            int rank = 0;
            for (int k = 0; k < tid; ++k) rank += cnt[k];
            const int8_t* v = vals + mb * cap;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                int val = 0;
                if ((byte >> (7 - j)) & 1) {
                    val = rank < cap ? v[rank] : 0;
                    ++rank;
                }
                lv[tid * 8 + j] = val;
            }
        }
        __syncthreads();
        // Escapes: the image's list ascends, so this MB's entries are the
        // run starting at the first position >= m*400.
        if (tid == 0) {
            const int32_t* pos = esc_pos + static_cast<long long>(b) * n_esc;
            const int16_t* val = esc_val + static_cast<long long>(b) * n_esc;
            const int lo_pos = m * kSlots, hi_pos = lo_pos + kSlots;
            int lo = 0, hi = n_esc;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (pos[mid] < lo_pos) lo = mid + 1; else hi = mid;
            }
            for (int i = lo; i < n_esc && pos[i] < hi_pos; ++i) lv[pos[i] - lo_pos] = val[i];
        }
    } else {
        const int16_t* src = levels + static_cast<long long>(b) * lv_stride + static_cast<long long>(m) * kSlots;
        for (int i = tid; i < kSlots; i += kThreads) lv[i] = src[i];
    }
    __syncthreads();

    // Dequantize with the MB's segment table.
    const int s = seg[b * seg_bs + m];
    const int16_t* q = qtab + static_cast<long long>(b) * q_stride + s * kSlots;
    for (int i = tid; i < kSlots; i += kThreads) lv[i] *= q[i];
    __syncthreads();

    const int lm = lmode[b * lm_bs + m];
    if (tid == 0) iwht4x4(lv + 24 * 16, y2dc);
    __syncthreads();
    // Y2 replaces the Y DCs of every MB that is not B-predicted.
    if (tid < 16 && lm != 4) lv[tid * 16] = y2dc[tid];
    __syncthreads();

    // The IDCT runs on every block: for an AC-free block it equals the
    // (dc + 4) >> 3 shortcut exactly.
    if (tid < 24) {
        int blk[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) blk[k] = lv[tid * 16 + k];
        idct4x4(blk);
#pragma unroll
        for (int k = 0; k < 16; ++k) lv[tid * 16 + k] = blk[k];
    }
    __syncthreads();
    int32_t* out = res + mb * (24 * 16);
    for (int i = tid; i < 24 * 16; i += kThreads) out[i] = lv[i];
    if (tid == 0) {
        const bool sub = lm == 4 || (!skipped[b * skip_bs + m] && non_zero[b * nz_bs + m]);
        do_sub[mb] = sub ? 1 : 0;
    }
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
    const dim3 grid(nmb, batch);
    residual_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bitmap), static_cast<const int8_t*>(vals), cap,
        static_cast<const int32_t*>(esc_pos), static_cast<const int16_t*>(esc_val), n_esc,
        static_cast<const int16_t*>(levels), lv_stride,
        static_cast<const int16_t*>(qtab), q_stride,
        static_cast<const uint8_t*>(seg), seg_bs, static_cast<const uint8_t*>(lmode), lm_bs,
        static_cast<const uint8_t*>(skipped), skip_bs, static_cast<const uint8_t*>(non_zero), nz_bs,
        nmb, static_cast<int32_t*>(res), static_cast<uint8_t*>(do_sub));
    return static_cast<int>(cudaGetLastError());
}
