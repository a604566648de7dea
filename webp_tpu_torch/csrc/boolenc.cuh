// The VP8 boolean (range) coder of RFC 6386 section 7.3 for one lane, in
// registers: the serial coder of `encode/boolenc.py:BoolEncoder`, run by
// one thread.  Shared by K13 (coefficient partitions), K14 (MB headers) and
// K15 (given op streams), in `tokens.cu`.
//
// The JAX package (webp_tpu/ops/boolenc2.py:89) codes every step with no
// feedback into the bytes and resolves the carries afterwards by carry
// lookahead; here a carry walks back through the lane's own bytes at
// once, turning 0xFF into 0x00, and one that runs past the lane's first
// byte adds 1 to `lead`.  Both give the same fields: `lead`, the bytes,
// their count and the final (bottom, range, bit_num).  The flush stays on
// the host (`encode/boolenc.py:assemble_lane`), since a header lane
// continues a host-written prefix.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct LaneCoder {
    uint32_t bottom;
    int range, bit_num;
    int n;         // bytes emitted; past `cap` they are counted, not written
    int lead;      // carries past the first byte
    long long ops;
    uint8_t* out;
    int cap;

    __device__ void init(uint32_t b, int r, int bn, uint8_t* o, int c) {
        bottom = b;
        range = r;
        bit_num = bn;
        n = lead = 0;
        ops = 0;
        out = o;
        cap = c;
    }

    // Renormalisation doubles the range at most 7 times, with at most one
    // emitted byte; the carries come before it.
    __device__ __forceinline__ void put(int bit, int prob) {
        const int split = 1 + (((range - 1) * prob) >> 8);
        if (bit) {
            bottom += static_cast<uint32_t>(split);
            range -= split;
        } else {
            range = split;
        }
        while (range < 128) {
            range <<= 1;
            if (bottom & 0x80000000u) carry();
            bottom <<= 1;
            if (--bit_num == 0) {
                if (n < cap) out[n] = static_cast<uint8_t>(bottom >> 24);
                ++n;
                bottom &= 0xFFFFFFu;
                bit_num = 8;
            }
        }
        ++ops;
    }

    __device__ void carry() {
        if (n > cap) return;  // the lane overflowed: its bytes are discarded
        int i = n - 1;
        while (i >= 0 && out[i] == 0xFF) out[i--] = 0;
        if (i >= 0) {
            ++out[i];
        } else {
            ++lead;
        }
    }

    // info [6]: lead, n_bytes, bottom, range, bit_num, n_ops.
    __device__ void finish(long long* info) const {
        info[0] = lead;
        info[1] = n;
        info[2] = bottom;
        info[3] = range;
        info[4] = bit_num;
        info[5] = ops;
    }
};
