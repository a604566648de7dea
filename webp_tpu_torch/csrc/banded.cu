// Kernels K16 recon_banded and K17 filter_banded: K2's reconstruction and
// K3's loop filter with each image's MB rows split into bands, one band per
// CTA of a thread-block cluster.
//
// Replace webp_tpu/parallel/pipeline.py:60 decode_wavefront_banded and its
// halo exchange :37 _band_shifts.  The JAX version shards the rows over the
// mesh's `band` axis and moves the ring borders between neighbour devices
// with ppermute at every wavefront step (1 recon row down, 4 filter margin
// rows down, 3 emission rows up).  Here the planes lie in global memory,
// so a band's neighbour rows are already where it reads them: the halo
// exchange becomes the cluster barrier that ends each step, whose arrive
// has release and whose wait has acquire semantics at cluster scope, so the
// rows a band wrote in step t (its last recon row, the filter's 3 rows
// written back into the band above) are visible to its neighbours in step
// t + 1.  Plane pointers are plain (not const __restrict__), so no load
// goes through the read-only path.
//
// Design: a grid of n_band x B CTAs in clusters of n_band along x; CTA
// `rank` of cluster b owns MB rows [rank * r_loc, (rank + 1) * r_loc) of
// image b, one warp per row as in K2 / K3, and at step t warp r does MB
// (t - 2r, r) with r the global row, so frame edges (127 above, 129 left,
// the top-right rule) come from the global row.  The MB work is K2's
// recon_mb and K3's filter_mb_lane, unchanged.
//
// Bound: as K2 and K3, the latency of the T = mbw + 2(mbh - 1) dependent
// steps, now each ended by a cluster barrier instead of __syncthreads(); a
// batch of B images occupies n_band * B SMs instead of B.

#include <cooperative_groups.h>

#include "filter_mb.cuh"
#include "recon_mb.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void recon_banded_kernel(const int32_t* __restrict__ res,
                                    const uint8_t* __restrict__ lmode, long long lm_bs,
                                    const uint8_t* __restrict__ bpred, long long bp_bs,
                                    const uint8_t* __restrict__ cmode, long long cm_bs,
                                    int mbw, int mbh, int n_band,
                                    uint8_t* y, long long y_bs, uint8_t* u, long long u_bs,
                                    uint8_t* v, long long v_bs) {
    cg::cluster_group cluster = cg::this_cluster();
    const int b = blockIdx.x / n_band;
    const int r_loc = mbh / n_band;
    const int lo = static_cast<int>(cluster.block_rank()) * r_loc;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const int nmb = mbw * mbh;
    uint8_t* Y = y + b * y_bs;
    uint8_t* U = u + b * u_bs;
    uint8_t* V = v + b * v_bs;
    const int T = wavefront_steps(mbw, mbh);
    for (int t = 0; t < T; ++t) {
        for (int r = lo + warp; r < lo + r_loc; r += nwarps) {
            const int x = t - 2 * r;
            if (x < 0 || x >= mbw) continue;
            const int m = r * mbw + x;
            recon_mb(lane, x, r, mbw, res + (static_cast<long long>(b) * nmb + m) * 24 * 16,
                     lmode[b * lm_bs + m], bpred + b * bp_bs + m * 16, cmode[b * cm_bs + m],
                     Y, U, V);
        }
        cluster.sync();
    }
}

__global__ void filter_banded_kernel(uint8_t* y, long long y_bs, uint8_t* u, long long u_bs,
                                     uint8_t* v, long long v_bs,
                                     const uint8_t* __restrict__ level, long long lv_bs,
                                     const uint8_t* __restrict__ interior, long long it_bs,
                                     const uint8_t* __restrict__ hev, long long hv_bs,
                                     const uint8_t* __restrict__ do_sub, long long ds_bs,
                                     int mbw, int mbh, int simple, int n_band) {
    cg::cluster_group cluster = cg::this_cluster();
    const int b = blockIdx.x / n_band;
    const int r_loc = mbh / n_band;
    const int lo = static_cast<int>(cluster.block_rank()) * r_loc;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    uint8_t* Y = y + b * y_bs;
    uint8_t* U = u + b * u_bs;
    uint8_t* V = v + b * v_bs;
    const int T = wavefront_steps(mbw, mbh);
    for (int t = 0; t < T; ++t) {
        for (int r = lo + warp; r < lo + r_loc; r += nwarps) {
            const int x = t - 2 * r;
            if (x < 0 || x >= mbw) continue;
            const int m = r * mbw + x;
            const int lvl = level[b * lv_bs + m];
            if (lvl == 0) continue;  // level 0 disables the whole MB
            filter_mb_lane(lane, x, r, mbw, simple != 0, lvl, interior[b * it_bs + m],
                           hev[b * hv_bs + m], do_sub[b * ds_bs + m] != 0, Y, U, V);
        }
        cluster.sync();
    }
}

// A launch of n_band x batch CTAs of `threads` in clusters of n_band.
cudaLaunchConfig_t cluster_config(int n_band, int batch, int threads, void* stream,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_band * batch);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = n_band;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// The launch's status, with the runtime's last error cleared either way, so
// that a refused launch is not reported again by the next kernel's check.
int status(cudaError_t launched) {
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(launched != cudaSuccess ? launched : last);
}

bool bad_bands(int mbh, int n_band) { return n_band < 1 || n_band > 8 || mbh % n_band != 0; }

}  // namespace

WEBP_API int webp_recon_banded(const void* res, const void* lmode, long long lm_bs,
                               const void* bpred, long long bp_bs, const void* cmode,
                               long long cm_bs, int mbw, int mbh, int batch, int n_band,
                               void* y, long long y_bs, void* u, long long u_bs, void* v,
                               long long v_bs, void* stream) {
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    if (bad_bands(mbh, n_band)) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(n_band, batch, wavefront_threads(mbh / n_band), stream, &attr);
    return status(cudaLaunchKernelEx(
        &cfg, recon_banded_kernel, static_cast<const int32_t*>(res),
        static_cast<const uint8_t*>(lmode), lm_bs, static_cast<const uint8_t*>(bpred), bp_bs,
        static_cast<const uint8_t*>(cmode), cm_bs, mbw, mbh, n_band,
        static_cast<uint8_t*>(y), y_bs, static_cast<uint8_t*>(u), u_bs,
        static_cast<uint8_t*>(v), v_bs));
}

WEBP_API int webp_filter_banded(void* y, long long y_bs, void* u, long long u_bs,
                                void* v, long long v_bs,
                                const void* level, long long lv_bs, const void* interior,
                                long long it_bs, const void* hev, long long hv_bs,
                                const void* do_sub, long long ds_bs,
                                int mbw, int mbh, int batch, int simple, int n_band,
                                void* stream) {
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    if (bad_bands(mbh, n_band)) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(n_band, batch, wavefront_threads(mbh / n_band), stream, &attr);
    return status(cudaLaunchKernelEx(
        &cfg, filter_banded_kernel, static_cast<uint8_t*>(y), y_bs,
        static_cast<uint8_t*>(u), u_bs, static_cast<uint8_t*>(v), v_bs,
        static_cast<const uint8_t*>(level), lv_bs, static_cast<const uint8_t*>(interior), it_bs,
        static_cast<const uint8_t*>(hev), hv_bs, static_cast<const uint8_t*>(do_sub), ds_bs,
        mbw, mbh, simple, n_band));
}

// How many clusters of n_band CTAs of `threads` each kernel can hold on the
// card at once (cudaOccupancyMaxActiveClusters): out[0] K16, out[1] K17.
WEBP_API int webp_banded_max_clusters(int n_band, int threads, int* out) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(n_band, 1, threads, nullptr, &attr);
    cudaError_t err = cudaOccupancyMaxActiveClusters(
        &out[0], reinterpret_cast<const void*>(recon_banded_kernel), &cfg);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveClusters(
            &out[1], reinterpret_cast<const void*>(filter_banded_kernel), &cfg);
    }
    return status(err);
}
