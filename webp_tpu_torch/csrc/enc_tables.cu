// Kernel K7: per-image rate tables from adapted token probabilities.
//
// Replaces webp_tpu/ops/encode_wavefront2.py:1405 enc_tables_from_probs.
// For each image, type, position, context and level v in 0..67:
//   pos_cost = cost of the token-tree path to v's token under the node
//              probabilities of the position's band (LevelCosts in
//              webp_tpu_torch/encode/costs.py), and from it the class, EOB
//              and "not EOB at a zero context" (init) costs.
// The JAX form sums the level codes' bit costs with byte-split float
// einsums (exact in bf16); here each thread sums its level's bits in
// integers.
//
// Bound: launch overhead.  B * 13,056 outputs of a few dozen integer ops
// from a 2 KB probability set and the 1 KB entropy-cost table.  Design: one
// thread per pos_cost entry, the tables in shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLevels = 68;                  // min(level, 67) + 1
constexpr int kRows = 4 * 16 * 3;            // (type, position, context)

__constant__ int kBands[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};
__constant__ int kClsReps[11] = {0, 1, 2, 3, 4, 5, 7, 11, 19, 35, 67};

__global__ void __launch_bounds__(kThreads) enc_tables_kernel(
    const uint8_t* __restrict__ probs, const int* __restrict__ tables, int* __restrict__ pos_cost,
    int* __restrict__ cls_cost, int* __restrict__ eob_cost, int* __restrict__ init_cost) {
    // tables: VP8_ENTROPY_COST [256], then VP8_LEVEL_CODES (pattern, bits) [67][2].
    __shared__ int ent[256], codes[67 * 2];
    for (int k = threadIdx.x; k < 256; k += kThreads) ent[k] = tables[k];
    for (int k = threadIdx.x; k < 67 * 2; k += kThreads) codes[k] = tables[256 + k];
    __syncthreads();

    const int b = blockIdx.y;
    const int idx = blockIdx.x * kThreads + threadIdx.x;
    if (idx >= kRows * kLevels) return;
    const int row = idx / kLevels, v = idx % kLevels;
    const int t = row / 48, pos = (row / 3) % 16, ctx = row % 3;
    const uint8_t* p = probs + ((((static_cast<long long>(b) * 4 + t) * 8 + kBands[pos]) * 3 + ctx)
                                * 11);
    const int cost0 = ctx > 0 ? ent[255 - p[0]] : 0;
    int cost;
    if (v == 0) {
        cost = ent[p[1]] + cost0;
    } else {
        cost = ent[255 - p[1]] + cost0;
        int pattern = codes[(v - 1) * 2], bits = codes[(v - 1) * 2 + 1];
        for (int i = 2; pattern; ++i, pattern >>= 1, bits >>= 1)
            if (pattern & 1) cost += (bits & 1) ? ent[255 - p[i]] : ent[p[i]];
    }
    const long long r = static_cast<long long>(b) * kRows + row;
    pos_cost[r * kLevels + v] = cost;
    for (int k = 0; k < 11; ++k)
        if (kClsReps[k] == v) cls_cost[r * 11 + k] = cost;
    if (v == 0) {
        eob_cost[r] = ent[p[0]];
        init_cost[r] = ent[255 - p[0]];
    }
}

}  // namespace

// probs: uint8 [batch, 4, 8, 3, 11]; outputs int32 [batch, 4, 16, 3, 68 | 11 | -].
WEBP_API int webp_enc_tables(const void* probs, const void* tables, int batch, void* pos_cost,
                             void* cls_cost, void* eob_cost, void* init_cost, void* stream) {
    if (batch <= 0) return 0;
    const dim3 grid((kRows * kLevels + kThreads - 1) / kThreads, batch);
    enc_tables_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(probs), static_cast<const int*>(tables),
        static_cast<int*>(pos_cost), static_cast<int*>(cls_cost), static_cast<int*>(eob_cost),
        static_cast<int*>(init_cost));
    return static_cast<int>(cudaGetLastError());
}
