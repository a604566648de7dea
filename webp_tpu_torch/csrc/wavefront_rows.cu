// Kernels K2 recon, K3 loopfilter and their fusion recon_filter: the
// decode's intra prediction + residue and its VP8 loop filter over the MB
// grid, as one kernel template rows_kernel<kRecon, kFilter>.
//
// Replaces (webp_tpu/ops/):
//   webp_recon         <1,0>  K2  wavefront2.py:152 recon_step (driven by
//                                 reconstruct_frames_v2 :337)
//   webp_loopfilter    <0,1>  K3  loopfilter2.py:192 filter_step (driven by
//                                 loop_filter_frames_v2 :281)
//   webp_recon_filter  <1,1>  K2+K3, the decode's main path:
//                                 wavefront2.py:274 decode_frames_fused_v2
// The JAX steps route rows through ring buffers and predict the ten B
// modes as one matmul, both TPU workarounds; here each predictor is
// computed directly (RFC 6386 12.3, common.cuh predict_b4) and each edge is
// filtered line by line (rows_mb.cuh filter_tile).
//
// Bound: latency of the dependency chain.  An MB needs its left, top-left,
// top and top-right neighbours, so an image's MBs form a chain of about
// T = mbw + 2(mbh - 1) MB latencies (110 at 768x512), each ended by a
// hand-over between rows; the bytes (the planes once, the per-MB inputs
// once) take microseconds.  Design: one CTA of four warps per (image, MB
// row) over the whole card and no barrier across an image.  A CTA takes
// its row from a ticket (an atomic counter the wrapper zeroes), rows in
// order of height, so it only ever waits on rows whose CTAs already run:
// no cooperative launch, no deadlock when the CTAs outnumber the resident
// slots.  A row runs in iterations: iteration i reconstructs MB i (K2) or
// filters it (K3); the fused kernel filters MB i - 1 on one warp while the
// other three reconstruct MB i, so it has mbw + 1 iterations.  Iteration i
// of row r starts when row r-1's progress counter reaches min(i + 2,
// iterations); thread 0 polls it with ld.acquire.gpu, other CTAs' pixels
// are read through L2 (__ldcg), and after the iteration's writes that the
// row below reads thread 0 publishes i + 1 with a fence and
// st.release.gpu.  The working MBs and the left neighbour's columns stay
// in shared memory.
//
// Dependencies of the fused kernel (a pixel "of" an MB lies in its 16x16):
// - Recon of (x, y) reads UNFILTERED pixels: the bottom row of (x-1..x+1,
//   y-1) (top-left corner, top, top-right; at x = mbw-1 the top-right
//   repeats column x0+15; at y = 0 the row above reads 127 and at x = 0
//   the left column 129), and the right column of (x-1, y).
// - Filtering (x, y) writes columns 16x-3..16x+15 of its 16 rows (the left
//   MB edge reaches 3 pixels into (x-1, y)) and rows 16y-3..16y-1 of
//   columns 16x..16x+15 (the top MB edge reaches into (x, y-1)).  Its
//   vertical edges change its bottom row, which recon of (x, y+1) and of
//   (x-1, y+1) (top-right) still needs unfiltered; its horizontal edges
//   change its right column, which recon of (x+1, y) still needs
//   unfiltered.  So each MB's unfiltered edges are saved before it is
//   filtered, as libwebp keeps its unfiltered top samples: the bottom row
//   in the per-row edge buffer in device memory (read by the row below
//   through L2), the right column in shared memory.
// - The filter of (x, y) needs (x-1, y), (x, y-1) and (x+1, y-1) fully
//   filtered ((x+1, y-1)'s left edge reaches columns 16x+13..16x+15 of
//   (x, y-1)); (x+2, y-1) does not touch (x, y-1).  Row y-1 has done both
//   by its iteration x + 1 (x + 2 in the fused kernel, which filters MB x
//   in iteration x + 1), and recon of (x, y) needs row y-1's recon up to
//   MB x + 1, done by its iteration x + 1: so the one wait, for row y-1's
//   iteration i + 1, serves the recon and the filter of iteration i, and
//   row y-1 touches none of the pixels that iteration reads or writes
//   after publishing i + 2.  In the fused kernel the recon of MB i and the
//   filter of MB i - 1 touch disjoint pixels, so they run side by side.
// - In the simple filter chroma is never filtered: recon's chroma is the
//   output.  A level-0 MB is not filtered.
//
// The MB work of an iteration, its phases and its memory rules are the row
// pipeline's (rows_mb.cuh run_row), here with a team of the CTA's four
// warps; the fused kernel filters on warp 3 while warps 0-2 reconstruct.

#include "rows_mb.cuh"

namespace {

constexpr int kThreads = 128;

// A row CTA's link to the row above: the counters in device memory, polled
// by thread 0 with ld.acquire.gpu and published after a fence with
// st.release.gpu; the CTA's barrier.
struct GlobalLink {
    const int* above;
    int* mine;
    __device__ void wait(int need) const {
        while (ld_acquire(above) < need) __nanosleep(32);
    }
    __device__ void sync() const { __syncthreads(); }
    __device__ void publish(int v) const {
        __threadfence();
        st_release(mine, v);
    }
};

// A CTA takes row r of image b from the ticket and runs it (run_row).
template <bool kRecon, bool kFilter>
__global__ void __launch_bounds__(kThreads) rows_kernel(const Args a) {
    __shared__ Shared S;
    __shared__ int row;
    if (threadIdx.x == 0) row = atomicAdd(a.prog + static_cast<long long>(a.batch) * a.mbh, 1);
    __syncthreads();
    const int b = row % a.batch, r = row / a.batch;
    int* prog = a.prog + static_cast<long long>(b) * a.mbh + r;
    run_row<kRecon, kFilter, kThreads>(a, S, threadIdx.x, b, r, GlobalLink{prog - 1, prog});
}

// One link of a chain of CTAs: CTA i (by ticket) waits until flag i-1 is set
// with the kernel's own acquire poll, then sets flag i with its release.
// Times the hand-over between rows that bounds the kernels above from below.
__global__ void handoff_chain_kernel(int n, int* flags) {
    __shared__ int ticket;
    if (threadIdx.x == 0) {
        ticket = atomicAdd(flags + n, 1);
        if (ticket > 0)
            while (ld_acquire(flags + ticket - 1) == 0) __nanosleep(32);
        __threadfence();
        st_release(flags + ticket, 1);
    }
}

int launch(bool recon, bool filter, const Args& a, void* stream) {
    if (a.mbw <= 0 || a.mbh <= 0 || a.batch <= 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(a.batch * a.mbh);
    if (recon && filter) rows_kernel<true, true><<<grid, kThreads, 0, s>>>(a);
    else if (recon) rows_kernel<true, false><<<grid, kThreads, 0, s>>>(a);
    else rows_kernel<false, true><<<grid, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

WEBP_API int webp_recon(const void* res, const void* lmode, long long lm_bs,
                        const void* bpred, long long bp_bs, const void* cmode, long long cm_bs,
                        int mbw, int mbh, int batch,
                        void* y, long long y_bs, void* u, long long u_bs, void* v, long long v_bs,
                        void* edge, void* prog, void* stream) {
    Args a = {};
    a.res = static_cast<const int32_t*>(res);
    a.lmode = static_cast<const uint8_t*>(lmode); a.lm_bs = lm_bs;
    a.bpred = static_cast<const uint8_t*>(bpred); a.bp_bs = bp_bs;
    a.cmode = static_cast<const uint8_t*>(cmode); a.cm_bs = cm_bs;
    a.mbw = mbw; a.mbh = mbh; a.batch = batch;
    a.y = static_cast<uint8_t*>(y); a.y_bs = y_bs;
    a.u = static_cast<uint8_t*>(u); a.u_bs = u_bs;
    a.v = static_cast<uint8_t*>(v); a.v_bs = v_bs;
    a.edge = static_cast<uint8_t*>(edge);
    a.prog = static_cast<int*>(prog);
    return launch(true, false, a, stream);
}

WEBP_API int webp_loopfilter(void* y, long long y_bs, void* u, long long u_bs,
                             void* v, long long v_bs,
                             const void* level, long long lv_bs, const void* interior, long long it_bs,
                             const void* hev, long long hv_bs, const void* do_sub, long long ds_bs,
                             int mbw, int mbh, int batch, int simple, void* prog, void* stream) {
    Args a = {};
    a.level = static_cast<const uint8_t*>(level); a.lv_bs = lv_bs;
    a.interior = static_cast<const uint8_t*>(interior); a.it_bs = it_bs;
    a.hev = static_cast<const uint8_t*>(hev); a.hv_bs = hv_bs;
    a.do_sub = static_cast<const uint8_t*>(do_sub); a.ds_bs = ds_bs;
    a.mbw = mbw; a.mbh = mbh; a.batch = batch; a.simple = simple;
    a.y = static_cast<uint8_t*>(y); a.y_bs = y_bs;
    a.u = static_cast<uint8_t*>(u); a.u_bs = u_bs;
    a.v = static_cast<uint8_t*>(v); a.v_bs = v_bs;
    a.prog = static_cast<int*>(prog);
    return launch(false, true, a, stream);
}

WEBP_API int webp_recon_filter(const void* res, const void* lmode, long long lm_bs,
                               const void* bpred, long long bp_bs, const void* cmode,
                               long long cm_bs, const void* level, long long lv_bs,
                               const void* interior, long long it_bs, const void* hev,
                               long long hv_bs, const void* do_sub, long long ds_bs,
                               int mbw, int mbh, int batch, int simple,
                               void* y, long long y_bs, void* u, long long u_bs, void* v,
                               long long v_bs, void* edge, void* prog, void* stream) {
    Args a = {};
    a.res = static_cast<const int32_t*>(res);
    a.lmode = static_cast<const uint8_t*>(lmode); a.lm_bs = lm_bs;
    a.bpred = static_cast<const uint8_t*>(bpred); a.bp_bs = bp_bs;
    a.cmode = static_cast<const uint8_t*>(cmode); a.cm_bs = cm_bs;
    a.level = static_cast<const uint8_t*>(level); a.lv_bs = lv_bs;
    a.interior = static_cast<const uint8_t*>(interior); a.it_bs = it_bs;
    a.hev = static_cast<const uint8_t*>(hev); a.hv_bs = hv_bs;
    a.do_sub = static_cast<const uint8_t*>(do_sub); a.ds_bs = ds_bs;
    a.mbw = mbw; a.mbh = mbh; a.batch = batch; a.simple = simple;
    a.y = static_cast<uint8_t*>(y); a.y_bs = y_bs;
    a.u = static_cast<uint8_t*>(u); a.u_bs = u_bs;
    a.v = static_cast<uint8_t*>(v); a.v_bs = v_bs;
    a.edge = static_cast<uint8_t*>(edge);
    a.prog = static_cast<int*>(prog);
    return launch(true, true, a, stream);
}

// Row CTAs of one instantiation the card keeps resident at once (the
// occupancy API over all SMs of the current device); -1 on an error.
WEBP_API int webp_recon_filter_resident(int recon, int filter) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return -1;
    const cudaError_t err =
        recon && filter ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_kernel<true, true>, kThreads, 0)
        : recon ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_kernel<true, false>, kThreads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_kernel<false, true>, kThreads, 0);
    return err == cudaSuccess ? per_sm * sms : -1;
}

// A chain of n CTAs handing a flag on (flags [n + 1] int32, zeroed; the last
// slot is the ticket): its time over n is one hand-over.
WEBP_API int webp_handoff_chain(int n, void* flags, void* stream) {
    if (n <= 0) return 0;
    handoff_chain_kernel<<<n, 32, 0, static_cast<cudaStream_t>(stream)>>>(n, static_cast<int*>(flags));
    return static_cast<int>(cudaGetLastError());
}
