// recon_mb: one MB's intra prediction + residue, by one warp, in place in
// the output planes, neighbours read back from the planes.  K16's
// (banded.cu); K2 (wavefront_rows.cu) keeps its MB in shared memory.
#pragma once

#include "common.cuh"

namespace {

__device__ void recon_mb(int lane, int x, int y, int mbw, const int32_t* __restrict__ rs,
                         int lm, const uint8_t* __restrict__ modes, int cm,
                         uint8_t* Y, uint8_t* U, uint8_t* V) {
    const int W = mbw * 16, CW = mbw * 8;
    const int y0 = y * 16, x0 = x * 16;
    if (lm == 4) {
        for (int i = 0; i < 16; ++i) {
            if (lane < 16) {
                const int sby = i >> 2, sbx = i & 3;
                const int py = y0 + sby * 4, px = x0 + sbx * 4;
                int e[13];
#pragma unroll
                for (int k = 0; k < 4; ++k) e[3 - k] = pix(Y, W, py + k, px - 1);
                e[4] = pix(Y, W, py - 1, px - 1);
#pragma unroll
                for (int k = 0; k < 4; ++k) e[5 + k] = pix(Y, W, py - 1, px + k);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    int v;
                    if (sbx < 3) {
                        v = pix(Y, W, py - 1, px + 4 + k);
                    } else if (y == 0) {
                        v = 127;  // the MB's top-right, used by every row of column 3
                    } else {
                        v = Y[(y0 - 1) * W + (x == mbw - 1 ? x0 + 15 : x0 + 16 + k)];
                    }
                    e[9 + k] = v;
                }
                int out[16];
                predict_b4(modes[i], e, out);
                int pred = 0;
#pragma unroll
                for (int k = 0; k < 16; ++k) pred = (k == lane) ? out[k] : pred;
                Y[(py + (lane >> 2)) * W + px + (lane & 3)] = clip255(pred + rs[i * 16 + lane]);
            }
            __syncwarp();
        }
    } else {
        const int dc = lm == 0 ? whole_dc(Y, W, y0, x0, 16, 4) : 0;
        for (int p = lane; p < 256; p += 32) {
            const int r = p >> 4, c = p & 15;
            const int pred = predict_whole(lm, Y, W, y0, x0, r, c, dc);
            const int blk = (r >> 2) * 4 + (c >> 2), k = (r & 3) * 4 + (c & 3);
            Y[(y0 + r) * W + x0 + c] = clip255(pred + rs[blk * 16 + k]);
        }
    }
    const int cy0 = y * 8, cx0 = x * 8;
    const int dcu = cm == 0 ? whole_dc(U, CW, cy0, cx0, 8, 3) : 0;
    const int dcv = cm == 0 ? whole_dc(V, CW, cy0, cx0, 8, 3) : 0;
    for (int p = lane; p < 128; p += 32) {
        const int pl = p >> 6, r = (p >> 3) & 7, c = p & 7;
        uint8_t* C = pl ? V : U;
        const int pred = predict_whole(cm, C, CW, cy0, cx0, r, c, pl ? dcv : dcu);
        const int blk = 16 + pl * 4 + (r >> 2) * 2 + (c >> 2), k = (r & 3) * 4 + (c & 3);
        C[(cy0 + r) * CW + cx0 + c] = clip255(pred + rs[blk * 16 + k]);
    }
}

}  // namespace
