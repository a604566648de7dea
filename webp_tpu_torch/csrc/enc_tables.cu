// Kernel K7: per-image rate tables from adapted token probabilities.
//
// Replaces webp_tpu/ops/encode_wavefront2.py:1405 enc_tables_from_probs.
// For each image, type, position, context and level v in 0..67:
//   pos_cost = cost of the token-tree path to v's token under the node
//              probabilities of the position's band (LevelCosts in
//              webp_tpu_torch/encode/costs.py), and from it the class, EOB
//              and "not EOB at a zero context" (init) costs.
// The JAX form sums the level codes' bit costs with byte-split float
// einsums (exact in bf16), then broadcasts the 8 bands to the 16
// positions; here the sums are integer.
//
// Bound: launch overhead.  B * 13,056 outputs of a few dozen integer ops
// from a 1 KB probability set and the 1.5 KB entropy-cost and level-code
// table; B * 62 KB of stores.
//
// Design: one CTA per (image, type).  One wave of loads puts the type's
// 264 probability bytes (8-byte loads) and the table in shared memory.
// The 24 distinct (band, ctx) rows x 68 levels are computed once: a lane a
// row, holding the row's node costs ent[p] and ent[255 - p] in registers,
// and warp w takes levels w, w + 8, ..., so that the level's code (its
// nodes and bits) is the same across the warp and its nodes unroll into
// selects and adds, with no divergence and no memory access.  Each row then goes to
// every position of its band, and cls_cost gathers the 11 representative
// levels from the shared rows, all in coalesced 16-byte stores (a row is
// 272 B); eob_cost and init_cost come from node 0.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLevels = 68;                  // min(level, 67) + 1
constexpr int kNodes = 11;
constexpr int kRows = 8 * 3;                 // distinct (band, ctx) rows of a type
constexpr int kPosRows = 16 * 3;             // (position, ctx) rows of a type's outputs
constexpr int kCls = 11;
constexpr int kTypeProbs = kRows * kNodes;   // 264 bytes
constexpr int kCodes = 67;                   // VP8_LEVEL_CODES (pattern, bits) for v = 1..67

// Band of position 0..15: a nibble each.
__device__ __forceinline__ int band_of(int pos) {
    return static_cast<int>((0x7666666665463210ull >> (4 * pos)) & 15);
}

// The class representatives 0, 1, 2, 3, 4, 5, 7, 11, 19, 35, 67.
__device__ __forceinline__ int class_rep(int k) { return k < 4 ? k : 3 + (1 << (k - 4)); }

__global__ void __launch_bounds__(kThreads) enc_tables_kernel(
    const uint8_t* __restrict__ probs, const int* __restrict__ tables, int* __restrict__ pos_cost,
    int* __restrict__ cls_cost, int* __restrict__ eob_cost, int* __restrict__ init_cost) {
    // tables: VP8_ENTROPY_COST [256], then VP8_LEVEL_CODES (pattern, bits) [67][2].
    __shared__ __align__(16) int ent[256];
    __shared__ __align__(8) int codes[2 * kCodes];
    __shared__ __align__(8) uint8_t p[kTypeProbs];
    __shared__ int node0[2][32];                      // [bit][row]: node 0's costs
    __shared__ __align__(16) int cost[kRows * kLevels];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long img_type = static_cast<long long>(blockIdx.y) * 4 + blockIdx.x;

    // 1. The loads, one a thread, in one wave.
    if (tid < 64) {
        reinterpret_cast<int4*>(ent)[tid] = reinterpret_cast<const int4*>(tables)[tid];
    } else if (tid < 64 + kCodes) {
        reinterpret_cast<int2*>(codes)[tid - 64] =
            reinterpret_cast<const int2*>(tables + 256)[tid - 64];
    } else if (tid < 64 + kCodes + kTypeProbs / 8) {
        reinterpret_cast<uint2*>(p)[tid - 64 - kCodes] =
            reinterpret_cast<const uint2*>(probs + img_type * kTypeProbs)[tid - 64 - kCodes];
    }
    __syncthreads();

    // 2. The distinct rows, a lane a row: the row's node costs (a 0 bit,
    //    a 1 bit) in registers, then levels w, w + 8, ... of warp w, whose
    //    codes are warp-uniform: no divergence, no memory in the sums.
    if (lane < kRows) {
        int zero[kNodes], one[kNodes];
#pragma unroll
        for (int node = 0; node < kNodes; ++node) {
            const int q = p[lane * kNodes + node];
            zero[node] = ent[q];
            one[node] = ent[255 - q];
        }
        if (warp == 0) {
            node0[0][lane] = zero[0];
            node0[1][lane] = one[0];
        }
        const int cost0 = lane % 3 ? one[0] : 0;
        for (int v = warp; v < kLevels; v += kWarps) {
            int c = zero[1] + cost0;
            if (v > 0) {
                c = one[1] + cost0;
                const int pattern = codes[2 * (v - 1)], bits = codes[2 * (v - 1) + 1];
#pragma unroll
                for (int node = 2; node < kNodes; ++node) {
                    const int t = (bits >> (node - 2)) & 1 ? one[node] : zero[node];
                    c += (pattern >> (node - 2)) & 1 ? t : 0;
                }
            }
            cost[lane * kLevels + v] = c;
        }
    }
    __syncthreads();

    // 3. The outputs of (image, type), in 16-byte stores: each band's row
    //    at every position of the band; the class representatives; node 0.
    int4* pc = reinterpret_cast<int4*>(pos_cost + img_type * (kPosRows * kLevels));
    for (int j = tid; j < kPosRows * kLevels / 4; j += kThreads) {
        const int pr = j / (kLevels / 4), q = j - pr * (kLevels / 4);
        const int pos = pr / 3, ctx = pr - pos * 3;
        pc[j] = reinterpret_cast<const int4*>(cost + (band_of(pos) * 3 + ctx) * kLevels)[q];
    }
    int4* cc = reinterpret_cast<int4*>(cls_cost + img_type * (kPosRows * kCls));
    for (int j = tid; j < kPosRows * kCls / 4; j += kThreads) {
        int v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int q = 4 * j + i, pr = q / kCls, k = q - pr * kCls;
            const int pos = pr / 3, ctx = pr - pos * 3;
            v[i] = cost[(band_of(pos) * 3 + ctx) * kLevels + class_rep(k)];
        }
        cc[j] = make_int4(v[0], v[1], v[2], v[3]);
    }
    if (tid < kPosRows / 2) {  // eob (tid < 12), then init
        const bool eob = tid < kPosRows / 4;
        const int j = eob ? tid : tid - kPosRows / 4;
        int v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int pr = 4 * j + i, pos = pr / 3, row = band_of(pos) * 3 + pr - pos * 3;
            v[i] = node0[eob ? 0 : 1][row];
        }
        reinterpret_cast<int4*>((eob ? eob_cost : init_cost) + img_type * kPosRows)[j] =
            make_int4(v[0], v[1], v[2], v[3]);
    }
}

}  // namespace

// probs: uint8 [batch, 4, 8, 3, 11] (8-byte aligned); tables 16-byte
// aligned; outputs int32 [batch, 4, 16, 3, 68 | 11 | -] (16-byte aligned).
WEBP_API int webp_enc_tables(const void* probs, const void* tables, int batch, void* pos_cost,
                             void* cls_cost, void* eob_cost, void* init_cost, void* stream) {
    if (batch <= 0) return 0;
    enc_tables_kernel<<<dim3(4, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(probs), static_cast<const int*>(tables),
        static_cast<int*>(pos_cost), static_cast<int*>(cls_cost), static_cast<int*>(eob_cost),
        static_cast<int*>(init_cost));
    return static_cast<int>(cudaGetLastError());
}
