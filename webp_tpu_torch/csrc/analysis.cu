// Kernel K8: the segment analysis, per-MB "alpha" compressibility.
//
// Replaces webp_tpu/ops/analysis2.py:128 analyze_alphas_batch (with its
// _dct4x4 :27, _alphas_from_coeffs :54 and _dc_tm_preds :107).  Each MB is
// predicted from its SOURCE neighbours (127 above the frame, 129 left of
// it) by DC and TrueMotion; the analysis DCT of every 4x4 residual goes
// into a 32-bin histogram of min(|coeff| >> 3, 31), and the histogram's
// last non-empty bin over its largest count gives the mode's alpha.  Luma
// (16 blocks) and chroma (U and V, 4 blocks each) keep their better mode;
// alpha = 255 - ((3 * luma + chroma + 2) >> 2), clipped, and the image's
// uv_alpha is the floor of the mean chroma alpha.
//
// Bound: integer operations (~88 M at batch 8, 768x512: 48 blocks an MB of
// prediction, DCT and histogram), the planes read once (4.7 MB) a close
// second.  No wavefront: every MB reads only source pixels.  Design:
//   - one CTA of 8 warps per (image, MB row, run of <= kSeg MBs of it); it
//     stages the run's 16 luma and 8 + 8 chroma pixel rows, the row above
//     each and the column left of it (127 / 129 outside the frame) in
//     shared memory with 16-byte loads, so no prediction reads global
//     memory or tests a border;
//   - a warp takes MBs two at a time in three rounds of 32 lanes: the luma
//     of the first MB (lane = mode * 16 + block), the luma of the second,
//     then the chroma of both (lane = MB * 16 + mode * 8 + plane * 4 +
//     block), so no lane idles in chroma;
//   - each MB's DC is one warp reduction of its neighbour row and column
//     (`__reduce_add_sync` for luma, 8-lane shuffles for the four chroma
//     DCs of a round), not a loop in every lane;
//   - histograms without atomics: a lane counts its 16 coefficients in its
//     own column of a [32 bins][36] counter tile (bank (4 * bin + lane) mod
//     32: conflict-free when the bins agree, as they mostly do in bin 0);
//     then lane b sums row b of each histogram's lanes with 128-bit loads
//     and zeroes it, and the alpha is a `__reduce_max_sync` and a ballot;
//   - the image's uv_alpha is finished on the card: a CTA adds its MBs'
//     chroma alphas into a per-image 64-bit sum, takes a ticket, and the
//     image's last CTA writes floor(sum / nmb) and zeroes the sum and the
//     ticket for the next call.  One launch a call.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSeg = 64;          // most MBs a CTA takes from one MB row
constexpr int kPad = 16;          // bytes left of a staged row (the left column at kPad - 1)
constexpr int kCntStride = 36;    // words a counter row: 128-bit rows, (4 * bin + lane) banks
constexpr int kCntWords = 32 * kCntStride;

struct Geometry {
    int seg;      // MBs of this CTA's run
    int ystride;  // bytes a staged luma row
    int cstride;  // bytes a staged chroma row
};

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline Geometry geometry(int seg) {
    return Geometry{seg, kPad + seg * 16, kPad + round16(seg * 8)};
}

__host__ __device__ inline int smem_bytes(int seg) {
    const Geometry g = geometry(seg);
    return 17 * g.ystride + 18 * g.cstride + kWarps * kCntWords * 4 + 16;
}

// libwebp's analysis FTransform of a row-major 4x4 residual.
__device__ __forceinline__ void analysis_dct(const int* d, int* out) {
    int t[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int d0 = d[4 * i], d1 = d[4 * i + 1], d2 = d[4 * i + 2], d3 = d[4 * i + 3];
        const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
        t[4 * i] = (a0 + a1) * 8;
        t[4 * i + 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
        t[4 * i + 2] = (a0 - a1) * 8;
        t[4 * i + 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c0 = t[j], c1 = t[4 + j], c2 = t[8 + j], c3 = t[12 + j];
        const int a0 = c0 + c3, a1 = c1 + c2, a2 = c1 - c2, a3 = c0 - c3;
        out[j] = (a0 + a1 + 7) >> 4;
        out[4 + j] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0);
        out[8 + j] = (a0 - a1 + 7) >> 4;
        out[12 + j] = (a3 * 2217 - a2 * 5352 + 51000) >> 16;
    }
}

// Copies `n` (16 or 8) bytes of a plane row from global to a 16-aligned
// shared address, with the widest loads the source's alignment allows.
__device__ __forceinline__ void copy_chunk(uint8_t* s, const uint8_t* g, int n) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(g);
    if (n == 16 && !(a & 15)) {
        *reinterpret_cast<uint4*>(s) = __ldg(reinterpret_cast<const uint4*>(g));
    } else if (!(a & 7)) {
        for (int k = 0; k < n; k += 8)
            *reinterpret_cast<uint2*>(s + k) = __ldg(reinterpret_cast<const uint2*>(g + k));
    } else {
        for (int k = 0; k < n; ++k) s[k] = __ldg(g + k);
    }
}

// The residual of the 4x4 block at (br, bc) of the n x n block whose top-left
// staged pixel is `org` (row stride `stride`) under DC (`tm` false, value
// `dc`) or TM, through the analysis DCT, counted into this lane's column
// `col` of a counter tile when `count`.
__device__ __forceinline__ void count_block(const uint8_t* org, int stride, int br, int bc,
                                            bool tm, int dc, int* col, bool count) {
    const int corner = org[-stride - 1];
    const uint32_t top = *reinterpret_cast<const uint32_t*>(org - stride + bc);
    int res[16], coef[16];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const uint32_t row = *reinterpret_cast<const uint32_t*>(org + (br + r) * stride + bc);
        const int left = org[(br + r) * stride - 1] - corner;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int pred = tm ? clip255(left + static_cast<int>((top >> (8 * c)) & 255)) : dc;
            res[4 * r + c] = static_cast<int>((row >> (8 * c)) & 255) - pred;
        }
    }
    analysis_dct(res, coef);
    if (count) {
#pragma unroll
        for (int k = 0; k < 16; ++k) col[min(abs(coef[k]) >> 3, 31) * kCntStride] += 1;
    }
}

// Alpha of the histogram whose count of bin `lane` is `count` (whole warp).
__device__ __forceinline__ int warp_alpha(int count) {
    const int mx = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(count)));
    const unsigned nz = __ballot_sync(kFull, count > 0);
    const int last = nz ? 31 - __clz(nz) : 1;
    return mx > 1 ? 510 * last / mx : 0;
}

// Lane b: the sums of row b of the counter tile over lane groups of `width`
// (16 or 8) lanes, into sums[32 / width]; the row is zeroed.
template <int width>
__device__ __forceinline__ void row_sums(int* cnt, int lane, int* sums) {
    uint4* row = reinterpret_cast<uint4*>(cnt + lane * kCntStride);
#pragma unroll
    for (int g = 0; g < 32 / width; ++g) {
        int s = 0;
#pragma unroll
        for (int q = 0; q < width / 4; ++q) {
            const uint4 v = row[g * (width / 4) + q];
            s += static_cast<int>(v.x + v.y + v.z + v.w);
        }
        sums[g] = s;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) row[q] = make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kThreads) analysis_kernel(
    const uint8_t* __restrict__ y, long long y_bs, const uint8_t* __restrict__ u, long long u_bs,
    const uint8_t* __restrict__ v, long long v_bs, int mbw, int mbh, int seg_mbs, int* alpha,
    int* uv_alpha, unsigned long long* acc) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.z, my = blockIdx.y, x0 = blockIdx.x * seg_mbs;
    const Geometry G = geometry(min(seg_mbs, mbw - x0));
    uint8_t* ys = smem;                          // 17 luma rows: the row above, then the MB row's
    uint8_t* cs = ys + 17 * G.ystride;           // 9 U rows, then 9 V rows
    int* cnt_all = reinterpret_cast<int*>(cs + 18 * G.cstride);
    unsigned long long* cta_sum =
        reinterpret_cast<unsigned long long*>(cnt_all + kWarps * kCntWords);
    const int W = mbw * 16, CW = mbw * 8;

    // 1. Stage the pixels: rows of 16-byte chunks (the last chroma chunk of
    //    an odd run is 8 bytes); the row above the frame is 127.
    const int ych = G.seg, cch = (G.seg + 1) >> 1;
    for (int k = tid; k < 17 * ych + 18 * cch; k += kThreads) {
        uint8_t* dst;
        const uint8_t* src;
        int gy, n = 16;
        if (k < 17 * ych) {
            const int r = k / ych, c = k - r * ych;
            gy = my * 16 - 1 + r;
            dst = ys + r * G.ystride + kPad + c * 16;
            src = y + b * y_bs + static_cast<long long>(gy) * W + x0 * 16 + c * 16;
        } else {
            const int k2 = k - 17 * ych, r = k2 / cch, c = k2 - r * cch, pl = r / 9;
            gy = my * 8 - 1 + (r - pl * 9);
            dst = cs + r * G.cstride + kPad + c * 16;
            src = (pl ? v + b * v_bs : u + b * u_bs) + static_cast<long long>(gy) * CW + x0 * 8
                  + c * 16;
            n = min(16, G.seg * 8 - c * 16);
        }
        if (gy < 0) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu,
                                                        0x7f7f7f7fu);
        } else {
            copy_chunk(dst, src, n);
        }
    }
    if (tid < 35) {  // the column left of the run: the MB to the left, 129 left of the frame
        const bool luma = tid < 17;
        const int r = luma ? tid : tid - 17, pl = luma ? 0 : r / 9;
        const int gy = luma ? my * 16 - 1 + r : my * 8 - 1 + (r - pl * 9);
        uint8_t* dst = luma ? ys + r * G.ystride + kPad - 1 : cs + r * G.cstride + kPad - 1;
        const uint8_t* row = luma ? y + b * y_bs + static_cast<long long>(gy) * W
                                  : (pl ? v + b * v_bs : u + b * u_bs)
                                        + static_cast<long long>(gy) * CW;
        *dst = gy < 0 ? 127 : (x0 > 0 ? __ldg(row + (luma ? x0 * 16 : x0 * 8) - 1) : 129);
    }
    int* cnt = cnt_all + warp * kCntWords;
    for (int k = lane; k < kCntWords; k += 32) cnt[k] = 0;
    if (tid == 0) *cta_sum = 0;
    __syncthreads();

    // 2. MBs two at a time on each warp: luma of the first, of the second,
    //    then the chroma of both.
    unsigned long long uv_part = 0;
    const bool above = my > 0;
    for (int i0 = 2 * warp; i0 < G.seg; i0 += 2 * kWarps) {
        const bool has2 = i0 + 1 < G.seg;
        int best_y0 = 0, best_y1 = 0;
        for (int j = 0; j < 1 + has2; ++j) {
            const int i = i0 + j;
            const bool left = x0 + i > 0;
            const uint8_t* org = ys + G.ystride + kPad + i * 16;
            const int nb = lane < 16 ? (above ? org[-G.ystride + lane] : 0)
                                     : (left ? org[(lane - 16) * G.ystride - 1] : 0);
            const int shf = 3 + above + left;
            const int total = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(nb)));
            const int dc = above || left ? (total + (1 << (shf - 1))) >> shf : 128;
            const int blk = lane & 15;
            count_block(org, G.ystride, (blk >> 2) * 4, (blk & 3) * 4, lane >= 16, dc, cnt + lane,
                        true);
            __syncwarp();
            int sums[2];
            row_sums<16>(cnt, lane, sums);
            __syncwarp();
            const int best = max(warp_alpha(sums[0]), warp_alpha(sums[1]));
            (j ? best_y1 : best_y0) = best;
        }
        // Chroma: lane = MB * 16 + mode * 8 + plane * 4 + block.  The DC of
        // (MB, plane) from the 8-lane segment lane >> 3 = MB * 2 + plane.
        {
            const int sm = lane >> 4, sp = (lane >> 3) & 1, k = lane & 7;
            const bool left = x0 + i0 + sm > 0, live = sm == 0 || has2;
            const uint8_t* org = cs + (sp * 9 + 1) * G.cstride + kPad + (i0 + sm) * 8;
            int nb = live ? (above ? org[-G.cstride + k] : 0) + (left ? org[k * G.cstride - 1] : 0)
                          : 0;
            nb += __shfl_xor_sync(kFull, nb, 4);
            nb += __shfl_xor_sync(kFull, nb, 2);
            nb += __shfl_xor_sync(kFull, nb, 1);
            const int shf = 2 + above + left;
            const int dc_seg = above || left ? (nb + (1 << (shf - 1))) >> shf : 128;
            const int mb = lane >> 4, mode = (lane >> 3) & 1, plane = (lane >> 2) & 1;
            const int blk = lane & 3;
            const int dc = __shfl_sync(kFull, dc_seg, (mb << 4) | (plane << 3));
            const uint8_t* borg = cs + (plane * 9 + 1) * G.cstride + kPad + (i0 + mb) * 8;
            count_block(borg, G.cstride, (blk >> 1) * 4, (blk & 1) * 4, mode == 1, dc, cnt + lane,
                        mb == 0 || has2);
            __syncwarp();
            int sums[4];
            row_sums<8>(cnt, lane, sums);
            __syncwarp();
            const int a0 = warp_alpha(sums[0]), a1 = warp_alpha(sums[1]);
            const int a2 = warp_alpha(sums[2]), a3 = warp_alpha(sums[3]);
            const int best_uv0 = max(a0, a1), best_uv1 = max(a2, a3);
            if (lane < 1 + has2) {
                const int a = lane ? (3 * best_y1 + best_uv1 + 2) >> 2
                                   : (3 * best_y0 + best_uv0 + 2) >> 2;
                alpha[(static_cast<long long>(b) * mbh + my) * mbw + x0 + i0 + lane] =
                    max(0, min(255, 255 - a));
            }
            uv_part += best_uv0 + (has2 ? best_uv1 : 0);
        }
    }

    // 3. The image's chroma sum: CTA total, per-image sum, ticket; the
    //    image's last CTA writes the floor of the mean and resets both.
    if (lane == 0) atomicAdd(cta_sum, uv_part);
    __syncthreads();
    if (tid == 0) {
        unsigned long long* img = acc + 2 * b;
        atomicAdd(img, *cta_sum);
        __threadfence();
        const unsigned long long ctas = static_cast<unsigned long long>(gridDim.x) * mbh;
        if (atomicAdd(img + 1, 1ull) == ctas - 1) {
            __threadfence();
            const unsigned long long total = atomicExch(img, 0ull);
            uv_alpha[b] = static_cast<int>(total / (static_cast<unsigned long long>(mbw) * mbh));
            img[1] = 0;
        }
    }
}

}  // namespace

// alpha: [batch, mbh * mbw] int32 out; uv_alpha: [batch] int32 out; acc:
// [batch, 2] uint64 (chroma sum, ticket), zero before the call and after it.
WEBP_API int webp_analysis(const void* y, long long y_bs, const void* u, long long u_bs,
                           const void* v, long long v_bs, int mbw, int mbh, int batch, int seg_mbs,
                           void* alpha, void* uv_alpha, void* acc, void* stream) {
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    if (seg_mbs <= 0 || seg_mbs > kSeg) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = smem_bytes(min(seg_mbs, mbw));
    const cudaError_t err = cudaFuncSetAttribute(
        analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kSeg));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((mbw + seg_mbs - 1) / seg_mbs, mbh, batch);
    analysis_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), y_bs, static_cast<const uint8_t*>(u), u_bs,
        static_cast<const uint8_t*>(v), v_bs, mbw, mbh, seg_mbs, static_cast<int*>(alpha),
        static_cast<int*>(uv_alpha), static_cast<unsigned long long*>(acc));
    return static_cast<int>(cudaGetLastError());
}
