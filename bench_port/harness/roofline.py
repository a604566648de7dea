"""The card's peaks and the least time of a workload's work on it.

The work is the algorithm's, counted from the cell's inputs and settings
alone (the frame geometry, the method's passes, tries and trellis, the MB
modes that the reference reads from the payloads, the planes, payloads and
RGB at their natural 8-bit widths, each read once and written once), never
from the port's tensors: a change of route or a fused kernel cannot move it.
The per-block operation counts are frozen copies of `chip_smoke.py`'s
(`bound`, `enc_ops`, the decode kernels' counts).
"""

from __future__ import annotations

# NVIDIA H100 SXM: HBM bytes/s (data sheet), and INT32 operations/s outside
# the tensor cores, where all the codec's work runs: 64 INT32 lanes per SM
# x 132 SMs x the 1.98 GHz boost clock.  Both assume the 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_INT_OPS = 64 * 132 * 1.98e9

# Integer operations per 4x4 block: a forward or inverse transform ~96, a
# quantization ~48, a rate ~64, prediction + residual + reconstruction + SSE
# ~96, the weighted Hadamard distortion of source and reconstruction ~128;
# one (position, level) node of the trellis ~40.
OPS_BLOCK_RD = 96 + 48 + 64 + 96 + 96 + 128
OPS_TRELLIS_NODE = 40
# Decode: a block's dequantisation and inverse transform, a YUV420 pixel's
# prediction and loop filter, an output pixel's upsampling and conversion.
OPS_BLOCK_IDCT = 16 + 96
OPS_PIXEL_RECON_FILTER = 28
OPS_PIXEL_RGB = 25


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the operations at the INT32 rate
    or the bytes at the HBM rate, whichever is longer."""
    return max(ops / PEAK_INT_OPS, nbytes / PEAK_BYTES)


def enc_ops(n_mb: int, n_i4: int, n_try: int, trellis: bool) -> float:
    """One RD pass's operations over n_mb MBs of which n_i4 chose I4."""
    i16 = 4 * 16 * OPS_BLOCK_RD + 4 * (2 * 96 + 48 + 64)   # 4 modes x 16 blocks, Y2
    i4 = 16 * (10 * 48 + n_try * OPS_BLOCK_RD) if n_try else 0  # 10 predictions, n_try tried
    uv = 4 * 8 * OPS_BLOCK_RD
    ops = n_mb * (i16 + i4 + uv)
    if trellis:  # I16: 16 blocks x 3 entry contexts; I4: 16 subblocks again
        ops += (n_mb - n_i4) * 16 * 3 * 32 * OPS_TRELLIS_NODE
        ops += n_i4 * 16 * (32 * OPS_TRELLIS_NODE + OPS_BLOCK_RD)
    return ops


def n_try_for(method: int) -> int:
    """B modes tried per subblock: 0 for methods 0-1, 3 for 2-3, 4 for
    method 4 and all 10 from method 5."""
    return 0 if method <= 1 else 3 if method <= 3 else 4 if method == 4 else 10


def encode_work(width: int, height: int, method: int, luma_modes, payload_bytes: int):
    """(operations, bytes) of one two-pass encode: pass 1 on the default
    tables at n_try <= 3 without the trellis, pass 2 at the method's n_try
    with the trellis from method 4; the YUV420 planes read once and the
    payload written once.  `luma_modes` are the payload's MB luma modes."""
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    n_mb = mbw * mbh
    n_i4 = int(sum(1 for m in luma_modes if m == 4))
    n_try = n_try_for(method)
    ops = enc_ops(n_mb, n_i4, min(n_try, 3), False) + enc_ops(n_mb, n_i4, n_try, method >= 4)
    return ops, n_mb * 384 + payload_bytes


def decode_work(width: int, height: int, luma_modes, payload_bytes: int):
    """(operations, bytes) of one decode to RGB: each MB's 24 blocks and its
    Y2 block (whole-block luma modes only) dequantised and transformed, the
    YUV420 planes predicted and filtered, the RGB upsampled and converted;
    the payload read once and the RGB written once."""
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    blocks = sum(25 if m != 4 else 24 for m in luma_modes)
    ops = (blocks * OPS_BLOCK_IDCT + mbw * mbh * 384 * OPS_PIXEL_RECON_FILTER
           + width * height * OPS_PIXEL_RGB)
    return ops, payload_bytes + width * height * 3
