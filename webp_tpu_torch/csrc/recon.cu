// Kernel K2: intra prediction + residue, in wavefront order.
//
// Replaces webp_tpu/ops/wavefront2.py:152 recon_step, driven over the MB
// grid by decode_frames_fused_v2 (:274, its recon half).  The JAX version
// predicts the ten 4x4 B modes as one [13]x[13,160] float matmul and routes
// rows through ring buffers, both TPU workarounds; here each predictor is
// computed directly as RFC 6386 / webp_tpu/ops/predict.py write it, and the
// neighbours are read back from the (unfiltered) output planes.
//
// Bound: latency of the dependency chain.  An MB needs its left, top-left,
// top and top-right neighbours, so the T = mbw + 2(mbh-1) anti-diagonals
// t = x + 2y run one after another, and inside a B-predicted MB the 16
// subblocks do too.  Design: one block per image, one warp per MB row; at
// step t warp r reconstructs MB (t - 2r, r), then the block synchronises.
// I16 and chroma spread their pixels over the 32 lanes; a B-predicted MB
// walks its subblocks with one lane per pixel.  At 768x512 at most 24 MBs
// are in flight per image, and a batch of B images fills only B SMs: the
// wavefront's parallelism, not the card, is the limit.

#include "recon_mb.cuh"

namespace {

// Plane pointers are deliberately not __restrict__/const: the kernel reads
// back pixels it wrote in earlier steps, so loads must stay coherent.
__global__ void recon_kernel(const int32_t* __restrict__ res,
                             const uint8_t* __restrict__ lmode, long long lm_bs,
                             const uint8_t* __restrict__ bpred, long long bp_bs,
                             const uint8_t* __restrict__ cmode, long long cm_bs,
                             int mbw, int mbh,
                             uint8_t* y, long long y_bs, uint8_t* u, long long u_bs,
                             uint8_t* v, long long v_bs) {
    const int b = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const int nmb = mbw * mbh;
    uint8_t* Y = y + b * y_bs;
    uint8_t* U = u + b * u_bs;
    uint8_t* V = v + b * v_bs;
    const int T = wavefront_steps(mbw, mbh);
    for (int t = 0; t < T; ++t) {
        for (int r = warp; r < mbh; r += nwarps) {
            const int x = t - 2 * r;
            if (x < 0 || x >= mbw) continue;
            const int m = r * mbw + x;
            recon_mb(lane, x, r, mbw, res + (static_cast<long long>(b) * nmb + m) * 24 * 16,
                     lmode[b * lm_bs + m], bpred + b * bp_bs + m * 16, cmode[b * cm_bs + m],
                     Y, U, V);
        }
        __syncthreads();
    }
}

}  // namespace

WEBP_API int webp_recon(const void* res, const void* lmode, long long lm_bs,
                        const void* bpred, long long bp_bs, const void* cmode, long long cm_bs,
                        int mbw, int mbh, int batch,
                        void* y, long long y_bs, void* u, long long u_bs, void* v, long long v_bs,
                        void* stream) {
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    recon_kernel<<<batch, wavefront_threads(mbh), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(res),
        static_cast<const uint8_t*>(lmode), lm_bs, static_cast<const uint8_t*>(bpred), bp_bs,
        static_cast<const uint8_t*>(cmode), cm_bs, mbw, mbh,
        static_cast<uint8_t*>(y), y_bs, static_cast<uint8_t*>(u), u_bs,
        static_cast<uint8_t*>(v), v_bs);
    return static_cast<int>(cudaGetLastError());
}
