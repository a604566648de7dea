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
// Bound: bytes.  No wavefront: every MB reads only source pixels, so the
// grid runs over (image, MB) in any order, one warp per MB.  It reads the
// planes once (0.59 MB per 768x512 image) and writes 4 bytes per MB.  In a
// warp, luma runs its 2 modes x 16 blocks on the 32 lanes and chroma its
// 2 modes x 2 planes x 4 blocks on 16; histograms are shared-memory
// integer atomics (exact and order-free), the max and last bin warp
// reductions.  The per-image chroma sums are 64-bit atomics; the wrapper
// divides them by the MB count.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // MBs per block

// libwebp's analysis FTransform of a row-major 4x4 residual.
__device__ void analysis_dct(const int* d, int* out) {
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

// Residual of 4x4 block (br, bc) of the n x n block at (row0, col0) under
// whole-block mode `mode` (0 DC, 3 TM), its analysis DCT into `hist`.
__device__ void block_histogram(const uint8_t* p, int stride, int row0, int col0, int mode,
                                int dc, int br, int bc, int* hist) {
    int res[16], coef[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int r = br + (k >> 2), c = bc + (k & 3);
        res[k] = p[(row0 + r) * stride + col0 + c] - predict_whole(mode, p, stride, row0, col0, r, c, dc);
    }
    analysis_dct(res, coef);
#pragma unroll
    for (int k = 0; k < 16; ++k) atomicAdd(&hist[min(abs(coef[k]) >> 3, 31)], 1);
}

// Alpha of a 32-bin histogram, computed by the whole warp (lane = bin).
__device__ int hist_alpha(const int* hist, int lane) {
    const int count = hist[lane];
    int mx = count;
    for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(kFull, mx, off));
    const unsigned nz = __ballot_sync(kFull, count > 0);
    const int last = nz ? 31 - __clz(nz) : 1;
    return mx > 1 ? 510 * last / mx : 0;
}

__global__ void __launch_bounds__(32 * kWarps) analysis_kernel(
    const uint8_t* __restrict__ y, long long y_bs, const uint8_t* __restrict__ u, long long u_bs,
    const uint8_t* __restrict__ v, long long v_bs, int mbw, int mbh, int batch, int* alpha,
    unsigned long long* uv_sum) {
    __shared__ int hist[kWarps][2][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long nmb = static_cast<long long>(mbw) * mbh;
    const long long job = static_cast<long long>(blockIdx.x) * kWarps + warp;
    if (job >= nmb * batch) return;  // the whole warp leaves together
    const int b = static_cast<int>(job / nmb), m = static_cast<int>(job % nmb);
    const int mx = m % mbw, my = m / mbw;
    int* h = &hist[warp][0][0];

    // Luma: lanes 0-15 predict DC, lanes 16-31 TM; lane & 15 is the block.
    h[lane] = h[32 + lane] = 0;
    __syncwarp();
    {
        const uint8_t* Y = y + b * y_bs;
        const int W = mbw * 16, blk = lane & 15;
        const int dc = whole_dc(Y, W, my * 16, mx * 16, 16, 4);
        block_histogram(Y, W, my * 16, mx * 16, lane < 16 ? 0 : 3, dc, (blk >> 2) * 4,
                        (blk & 3) * 4, h + (lane >> 4) * 32);
    }
    __syncwarp();
    const int best_y = max(hist_alpha(h, lane), hist_alpha(h + 32, lane));
    __syncwarp();

    // Chroma: lane = mode * 8 + plane * 4 + block on lanes 0-15.
    h[lane] = h[32 + lane] = 0;
    __syncwarp();
    if (lane < 16) {
        const int plane = (lane >> 2) & 1, blk = lane & 3, CW = mbw * 8;
        const uint8_t* C = plane ? v + b * v_bs : u + b * u_bs;
        const int dc = whole_dc(C, CW, my * 8, mx * 8, 8, 3);
        block_histogram(C, CW, my * 8, mx * 8, lane < 8 ? 0 : 3, dc, (blk >> 1) * 4,
                        (blk & 1) * 4, h + (lane >> 3) * 32);
    }
    __syncwarp();
    const int best_uv = max(hist_alpha(h, lane), hist_alpha(h + 32, lane));
    if (lane == 0) {
        const int a = (3 * best_y + best_uv + 2) >> 2;
        alpha[job] = max(0, min(255, 255 - a));
        atomicAdd(uv_sum + b, static_cast<unsigned long long>(best_uv));
    }
}

}  // namespace

WEBP_API int webp_analysis(const void* y, long long y_bs, const void* u, long long u_bs,
                           const void* v, long long v_bs, int mbw, int mbh, int batch, void* alpha,
                           void* uv_sum, void* stream) {
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    const long long jobs = static_cast<long long>(mbw) * mbh * batch;
    const unsigned blocks = static_cast<unsigned>((jobs + kWarps - 1) / kWarps);
    analysis_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), y_bs, static_cast<const uint8_t*>(u), u_bs,
        static_cast<const uint8_t*>(v), v_bs, mbw, mbh, batch, static_cast<int*>(alpha),
        static_cast<unsigned long long*>(uv_sum));
    return static_cast<int>(cudaGetLastError());
}
