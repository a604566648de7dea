// Kernels K16 recon_banded and K17 filter_banded: K2's reconstruction and
// K3's loop filter with each image's MB rows split into bands, one band per
// CTA of a thread-block cluster.
//
// Replace webp_tpu/parallel/pipeline.py:60 decode_wavefront_banded and its
// halo exchange :37 _band_shifts.  The JAX version shards the rows over the
// mesh's `band` axis and moves the ring borders between neighbour devices
// with ppermute at every wavefront step (1 recon row down, 4 filter margin
// rows down, 3 emission rows up).  Here the planes and the rows' unfiltered
// bottom pixels lie in device memory, where a band reads its neighbour's
// rows; what crosses between bands is the progress of the band's last row,
// which the band below reads from its neighbour's shared memory.
//
// Bound: as K2 and K3, the latency of the T = mbw + 2(mbh - 1) dependent MB
// iterations, each gated on a hand-over from the row above; the bytes take
// microseconds.  Design: a grid of n_band x B CTAs in clusters of n_band
// along x; CTA `rank` of cluster b owns MB rows [rank * r_loc, (rank + 1) *
// r_loc) of image b and runs them as G = min(r_loc, kMaxPipes) row
// pipelines of one warp each: pipeline g takes the band's rows g, g + G,
// ... in order, each through the row pipeline of rows_mb.cuh (run_row, the
// MB work of K2 and K3 with a team of one warp: the subblock wavefront,
// then chroma; the filter on the warp's lanes, one line a lane).  A team of
// one warp meets at __syncwarp, so no named barrier limits G.  Each row's
// progress counter lives in the CTA's shared memory: lane 0 publishes it
// after the warp's writes with st.release, and the row below polls it with
// ld.acquire: at CTA scope in the same CTA for a row inside the band; at
// cluster scope, through distributed shared memory (cluster.map_shared_rank),
// for the band's first row, which waits on the last row of the CTA above.
// Pixels another warp or CTA wrote are read through L2 (__ldcg) after the
// acquire (a load's cache operator does not change its memory ordering).
// A pipeline's rows rise and a row only waits on the row above, whose
// pipeline is at least as far along; the cluster's CTAs are co-scheduled:
// so no ticket is needed and nothing deadlocks.  The wavefront loop has no
// cluster barrier: one after the counters are zeroed (no CTA polls a
// neighbour that has not started) and one before the CTAs exit (a neighbour
// may still poll this CTA's counters).
//
// Size (H100: 65,536 registers, 227 KB of shared memory a CTA): kMaxPipes
// = 24 warps of 768 threads, so __launch_bounds__ holds each thread to 80
// registers; 24 x 5,000 B of tiles.  At 768x512 (48 x 32 MBs) a band of
// r_loc <= 24 rows gets a pipeline a row; at n_band 1 (r_loc 32) rows
// start every max(2, mbw / G) = 2 iterations, the wavefront's own pace.

#include <cooperative_groups.h>

#include "rows_mb.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPipes = 24;  // row pipelines (warps) of a band's CTA

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
    int v;
    asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ int ld_acquire_cluster(const int* p) {
    int v;
    asm volatile("ld.acquire.cluster.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
    asm volatile("st.release.cta.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_release_cluster(int* p, int v) {
    asm volatile("st.release.cluster.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A row pipeline's link to the row above: the counters in shared memory,
// the above row's in this CTA or, for the band's first row (`from_cluster`),
// mapped from the CTA above; the team is one warp.  Release and acquire are
// at CTA scope between rows of a band, at cluster scope where a counter
// crosses to the band below (`to_cluster`, the band's last row) or from the
// band above.
struct BandLink {
    const int* above;
    int* mine;
    bool from_cluster, to_cluster;
    __device__ void wait(int need) const {
        if (from_cluster)
            while (ld_acquire_cluster(above) < need) __nanosleep(32);
        else
            while (ld_acquire_cta(above) < need) __nanosleep(32);
    }
    __device__ void sync() const { __syncwarp(); }
    __device__ void publish(int v) const {
        if (to_cluster) st_release_cluster(mine, v);
        else st_release_cta(mine, v);
    }
};

// Bytes of the counters ahead of the pipelines' tiles, 16-byte aligned.
__host__ __device__ int counter_bytes(int r_loc) { return (r_loc * 4 + 15) & ~15; }

int pipes(int r_loc) { return r_loc < kMaxPipes ? r_loc : kMaxPipes; }

int smem_bytes(int r_loc) {
    return counter_bytes(r_loc) + pipes(r_loc) * static_cast<int>(sizeof(Shared));
}

template <bool kRecon, bool kFilter>
__global__ void __launch_bounds__(kMaxPipes * 32, 1) banded_kernel(const Args a, int n_band) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int r_loc = a.mbh / n_band;
    const int rank = static_cast<int>(cluster.block_rank());
    const int b = blockIdx.x / n_band;
    int* done = reinterpret_cast<int*>(smem);  // finished iterations of each row of the band
    Shared* tiles = reinterpret_cast<Shared*>(smem + counter_bytes(r_loc));
    for (int k = threadIdx.x; k < r_loc; k += blockDim.x) done[k] = 0;
    cluster.sync();
    const int g = threadIdx.x >> 5, lane = threadIdx.x & 31, n_pipe = blockDim.x >> 5;
    const int* last_above = rank > 0 ? cluster.map_shared_rank(done + r_loc - 1, rank - 1) : done;
    for (int j = g; j < r_loc; j += n_pipe) {
        const BandLink link{j > 0 ? done + j - 1 : last_above, done + j, j == 0,
                            j == r_loc - 1 && rank + 1 < n_band};
        run_row<kRecon, kFilter, 32>(a, tiles[g], lane, b, rank * r_loc + j, link);
    }
    cluster.sync();
}

// A ring of hand-overs between row pipelines: `warps` warps of one CTA
// (a cluster of one), or a cluster of `ctas` CTAs of one warp each; each
// warp in turn waits on its predecessor's counter and publishes its own,
// `rounds` times around, with BandLink's wait and publish.  Its time over
// warps x ctas x rounds is one hand-over: inside a band, or across bands.
__global__ void band_handoff_kernel(int rounds) {
    __shared__ int done[32];
    cg::cluster_group cluster = cg::this_cluster();
    const int n_cta = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warp = blockDim.x >> 5;
    if (threadIdx.x < 32) done[threadIdx.x] = 0;
    cluster.sync();
    const int n = n_cta * n_warp, p = rank * n_warp + w, q = (p + n - 1) % n;
    const int* above = q / n_warp == rank ? done + q % n_warp
                                          : cluster.map_shared_rank(done + q % n_warp, q / n_warp);
    const BandLink link{above, done + w, n_cta > 1, n_cta > 1};
    for (int k = 0; k < rounds; ++k) {
        if (lane == 0 && (p > 0 || k > 0)) link.wait(p > 0 ? k + 1 : k);
        link.sync();
        if (lane == 0) link.publish(k + 1);
    }
    cluster.sync();
}

// A launch of n_band x batch CTAs of `threads` with `smem` bytes of dynamic
// shared memory, in clusters of n_band.
cudaLaunchConfig_t cluster_config(int n_band, int batch, int threads, int smem, void* stream,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_band * batch);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
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

// The kernel's launch shape for bands of r_loc rows (shared memory above
// 48 KB must be allowed per kernel first).
template <bool kRecon, bool kFilter>
cudaError_t shape(int n_band, int mbh, int batch, void* stream, cudaLaunchAttribute* attr,
                  cudaLaunchConfig_t* cfg) {
    const int r_loc = mbh / n_band;
    *cfg = cluster_config(n_band, batch, 32 * pipes(r_loc), smem_bytes(r_loc), stream, attr);
    return cudaFuncSetAttribute(banded_kernel<kRecon, kFilter>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(r_loc));
}

template <bool kRecon, bool kFilter>
int launch(const Args& a, int n_band, void* stream) {
    if (a.mbw <= 0 || a.mbh <= 0 || a.batch <= 0) return 0;
    if (bad_bands(a.mbh, n_band)) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    const cudaError_t err = shape<kRecon, kFilter>(n_band, a.mbh, a.batch, stream, &attr, &cfg);
    if (err != cudaSuccess) return status(err);
    return status(cudaLaunchKernelEx(&cfg, banded_kernel<kRecon, kFilter>, a, n_band));
}

template <bool kRecon, bool kFilter>
cudaError_t max_clusters(int n_band, int mbh, int* out) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    const cudaError_t err = shape<kRecon, kFilter>(n_band, mbh, 1, nullptr, &attr, &cfg);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(
        out, reinterpret_cast<const void*>(banded_kernel<kRecon, kFilter>), &cfg);
}

}  // namespace

WEBP_API int webp_recon_banded(const void* res, const void* lmode, long long lm_bs,
                               const void* bpred, long long bp_bs, const void* cmode,
                               long long cm_bs, int mbw, int mbh, int batch, int n_band,
                               void* y, long long y_bs, void* u, long long u_bs, void* v,
                               long long v_bs, void* edge, void* stream) {
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
    return launch<true, false>(a, n_band, stream);
}

WEBP_API int webp_filter_banded(void* y, long long y_bs, void* u, long long u_bs,
                                void* v, long long v_bs,
                                const void* level, long long lv_bs, const void* interior,
                                long long it_bs, const void* hev, long long hv_bs,
                                const void* do_sub, long long ds_bs,
                                int mbw, int mbh, int batch, int simple, int n_band,
                                void* stream) {
    Args a = {};
    a.level = static_cast<const uint8_t*>(level); a.lv_bs = lv_bs;
    a.interior = static_cast<const uint8_t*>(interior); a.it_bs = it_bs;
    a.hev = static_cast<const uint8_t*>(hev); a.hv_bs = hv_bs;
    a.do_sub = static_cast<const uint8_t*>(do_sub); a.ds_bs = ds_bs;
    a.mbw = mbw; a.mbh = mbh; a.batch = batch; a.simple = simple;
    a.y = static_cast<uint8_t*>(y); a.y_bs = y_bs;
    a.u = static_cast<uint8_t*>(u); a.u_bs = u_bs;
    a.v = static_cast<uint8_t*>(v); a.v_bs = v_bs;
    return launch<false, true>(a, n_band, stream);
}

// The CTA shape of a band of mbh / n_band rows: out[0] row pipelines (warps),
// out[1] bytes of dynamic shared memory; then how many such clusters of
// n_band CTAs each kernel can hold on the card at once
// (cudaOccupancyMaxActiveClusters): out[2] K16, out[3] K17.
WEBP_API int webp_banded_max_clusters(int n_band, int mbh, int* out) {
    if (mbh <= 0 || bad_bands(mbh, n_band)) return static_cast<int>(cudaErrorInvalidValue);
    out[0] = pipes(mbh / n_band);
    out[1] = smem_bytes(mbh / n_band);
    cudaError_t err = max_clusters<true, false>(n_band, mbh, &out[2]);
    if (err == cudaSuccess) err = max_clusters<false, true>(n_band, mbh, &out[3]);
    return status(err);
}

// `rounds` times around a ring of `warps` warps of one CTA (ctas == 1) or of
// `ctas` CTAs of one warp in a cluster (warps == 1).
WEBP_API int webp_band_handoff_chain(int ctas, int warps, int rounds, void* stream) {
    if (ctas < 1 || ctas > 8 || warps < 1 || warps > 32 || (ctas > 1 && warps > 1) || rounds < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(ctas, 1, 32 * warps, 0, stream, &attr);
    return status(cudaLaunchKernelEx(&cfg, band_handoff_kernel, rounds));
}
