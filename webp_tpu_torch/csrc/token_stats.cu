// Kernel K6: per-image token statistics of the pass-1 levels.
//
// Replaces webp_tpu/ops/token_stats.py:183 token_stats_device (with
// compute_contexts_j :49, _block_events :90, _accumulate :161).  The JAX
// form builds (block, position, node) event masks and sums them by band
// with a float matmul; here each thread walks one block's tokens as the
// coder would (the host C++ vp8_token_stats walk) and counts the events
// with integer shared-memory atomics.  Integer counts are exact in any
// order, so the result does not depend on the schedule.
//
// Bound: memory.  Each block of levels (32 bytes) is read once, plus the
// 16 levels of up to two neighbour blocks for its contexts (cached), and
// a Y2 context walks up its column and left along its row to the nearest
// MB that has a Y2 block.  Design: a grid of (MB chunks, images), one
// thread per (MB, block) of the 25 blocks of an MB; the [4, 8, 3, 11]
// (total, ones) counters live in shared memory and are added to the
// output with global atomics once per thread block.

#include "common.cuh"
#include "contexts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCounters = 4 * 8 * 3 * 11;

__constant__ int kBands[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};

__global__ void __launch_bounds__(kThreads) token_stats_kernel(
    const uint8_t* __restrict__ lmode, long long lm_bs, const uint8_t* __restrict__ skipped,
    long long sk_bs, const int16_t* __restrict__ y2, const int16_t* __restrict__ y,
    const int16_t* __restrict__ uv, int mbw, int mbh, int batch, int* __restrict__ out) {
    __shared__ int tot[kCounters], ones[kCounters];
    for (int k = threadIdx.x; k < kCounters; k += kThreads) tot[k] = ones[k] = 0;
    __syncthreads();

    const int b = blockIdx.y;
    const int nmb = mbw * mbh;
    const long long img = static_cast<long long>(b) * nmb;
    const Levels L{lmode + b * lm_bs, y2 + img * 16, y + img * 256, uv + img * 128};
    const int idx = blockIdx.x * kThreads + threadIdx.x;
    const int m = idx / 25, slot = idx % 25;
    if (m < nmb && !skipped[b * sk_bs + m]) {
        const int mx = m % mbw, my = m / mbw;
        const bool has_y2 = L.lmode[m] != 4;
        int ctype = -1, first = 0, ctx = 0;
        const int16_t* blk = nullptr;
        if (slot == 0) {
            if (has_y2) {
                ctype = 1;
                blk = L.y2 + m * 16;
                ctx = y2_ctx(L, m, mx, my, mbw);
            }
        } else if (slot <= 16) {
            const int s = slot - 1;
            ctype = has_y2 ? 0 : 3;
            first = has_y2 ? 1 : 0;
            blk = L.y + (m * 16 + s) * 16;
            ctx = y_ctx(L, m, s, mx, my, mbw);
        } else {
            const int s = slot - 17;
            ctype = 2;
            blk = L.uv + (m * 8 + s) * 16;
            ctx = uv_ctx(L, m, s, mx, my, mbw);
        }
        if (ctype >= 0) {
            const int base = ctype * 8;
            auto rec = [&](int band, int node, int bit) {
                const int c = ((base + band) * 3 + ctx) * 11 + node;
                atomicAdd(&tot[c], 1);
                if (bit) atomicAdd(&ones[c], 1);
            };
            int end = 0;
            for (int k = 15; k >= first; --k) {
                if (blk[k] != 0) {
                    end = k + 1;
                    break;
                }
            }
            if (end <= first) {
                rec(kBands[first], 0, 0);  // an empty block: one EOB
            } else {
                bool skip_eob = false;
                for (int n = first; n < end; ++n) {
                    const int band = kBands[n];
                    const int v = abs(static_cast<int>(blk[n]));
                    if (!skip_eob) rec(band, 0, 1);
                    if (v == 0) {
                        rec(band, 1, 0);
                        skip_eob = true;
                        ctx = 0;
                        continue;
                    }
                    rec(band, 1, 1);
                    skip_eob = false;
                    if (v == 1) {
                        rec(band, 2, 0);
                        ctx = 1;
                        continue;
                    }
                    rec(band, 2, 1);
                    const int vc = min(v, 67);
                    if (vc <= 4) {
                        rec(band, 3, 0);
                        rec(band, 4, vc != 2);
                        if (vc != 2) rec(band, 5, vc == 4);
                    } else if (vc <= 10) {
                        rec(band, 3, 1);
                        rec(band, 6, 0);
                        rec(band, 7, vc > 6);
                    } else {
                        rec(band, 3, 1);
                        rec(band, 6, 1);
                        if (vc < 3 + (8 << 2)) {
                            rec(band, 8, 0);
                            rec(band, 9, vc >= 3 + (8 << 1));
                        } else {
                            rec(band, 8, 1);
                            rec(band, 10, vc >= 3 + (8 << 3));
                        }
                    }
                    ctx = 2;
                }
                if (end < 16) rec(kBands[end], 0, 0);  // the trailing EOB
            }
        }
    }
    __syncthreads();
    int* o_tot = out + b * kCounters;
    int* o_ones = out + (static_cast<long long>(batch) + b) * kCounters;
    for (int k = threadIdx.x; k < kCounters; k += kThreads) {
        if (tot[k]) atomicAdd(&o_tot[k], tot[k]);
        if (ones[k]) atomicAdd(&o_ones[k], ones[k]);
    }
}

}  // namespace

// out: int32 [2, batch, 4, 8, 3, 11] (totals, then ones), zero-filled by the caller.
WEBP_API int webp_token_stats(const void* lmode, long long lm_bs, const void* skipped,
                              long long sk_bs, const void* y2, const void* y, const void* uv,
                              int mbw, int mbh, int batch, void* out, void* stream) {
    if (mbw <= 0 || mbh <= 0 || batch <= 0) return 0;
    const dim3 grid((mbw * mbh * 25 + kThreads - 1) / kThreads, batch);
    token_stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(lmode), lm_bs, static_cast<const uint8_t*>(skipped), sk_bs,
        static_cast<const int16_t*>(y2), static_cast<const int16_t*>(y),
        static_cast<const int16_t*>(uv), mbw, mbh, batch, static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}
