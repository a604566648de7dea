"""Kernel K15: the VP8 boolean coder over many lanes, and its plain twins.

Replaces `webp_tpu/ops/boolenc2.py:89` `bool_encode_lanes` (with `_apply_op`
:34).  Per lane, an op stream of (bit, prob, valid) steps is coded by the
range coder of RFC 6386 section 7.3 (`encode/boolenc.py:BoolEncoder`), and
the lane reports what the host epilogue (`encode/boolenc.py:assemble_lane`)
needs: `lead`, the carries that ran past the lane's first byte (into a
host prefix when the lane continues an encoder's state); the lane's
carry-resolved bytes and their count `n_bytes`; the final (bottom, range,
bit_num) registers; and `n_ops`, the valid steps.

The coder itself is the `__device__` one of `csrc/boolenc.cuh`, which K13
(coefficient partitions) and K14 (MB headers) run on ops they generate;
K15 (`csrc/tokens.cu`) runs it alone on given streams, one thread per
lane.  A lane whose output exceeds `max_bytes` keeps counting `n_bytes`
and stops writing; its bytes are then not valid.

Two plain twins.  `bool_encode_lanes_plain` follows the JAX form: one
vectorised step per op over all lanes, whose outputs are a possibly
emitted byte and a count of carries (no feedback into the bytes), then the
carries resolved as base-256 addition by carry lookahead.  A step's
renormalisation is written in closed form: `s` doublings (range back to
>= 128), at most one emitted byte when the bit counter reaches 0, and the
carries are the bits that leave bottom's top before that byte.
`lane_coder_plain` is the device step itself, one lane at a time in
Python integers: the same closed form with s = clz(range) - 24, each byte
stored as it leaves, a carry marked at the byte it precedes, and the marks
applied after the lane's last op (latest first, to show that their order
does not matter), as `resolve_carries` does on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build

# Doublings that bring a range in 1..255 back to >= 128.
_NORM = np.array([0] + [7 - int(np.log2(r)) for r in range(1, 256)], np.int64)
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.int64)


class Lanes(NamedTuple):
    """Per-lane coder outputs ([...] is the lanes' shape): lead, n_bytes,
    bottom (the uint32 register), range, bit_num and n_ops int64 [...];
    data uint8 [..., width], each lane's first n_bytes valid."""
    lead: torch.Tensor
    data: torch.Tensor
    n_bytes: torch.Tensor
    bottom: torch.Tensor
    range: torch.Tensor
    bit_num: torch.Tensor
    n_ops: torch.Tensor

    def fields(self) -> torch.Tensor:
        """int64 [..., 6]: lead, n_bytes, bottom, range, bit_num, n_ops."""
        return torch.stack([self.lead, self.n_bytes, self.bottom, self.range, self.bit_num,
                            self.n_ops], dim=-1)

    @staticmethod
    def from_fields(info: torch.Tensor, data: torch.Tensor) -> "Lanes":
        return Lanes(info[..., 0], data, *(info[..., k] for k in range(1, 6)))


INIT_STATE = (0, 255, 24)  # a fresh coder's (bottom, range, bit_num)


def carry_words(cap: int) -> int:
    """int32 words of a lane's carry mask at byte capacity `cap`
    (`csrc/boolenc.cuh` carry_words)."""
    return (cap >> 5) + 1


def _apply_op(state, bit, prob, ok, norm, popcount):
    """One coder op on every lane (int64 [L] tensors): the new (bottom,
    range, bit_num) and this step's (byte, emitted, carries)."""
    bottom, rng, bit_num = state
    split = 1 + (((rng - 1) * prob) >> 8)
    one = bit != 0
    bottom2 = torch.where(one, bottom + split, bottom) & 0xFFFFFFFF
    rng2 = torch.where(one, rng - split, split)
    s = norm[rng2]
    emitted = bit_num <= s
    j = torch.where(emitted, bit_num, s)  # doublings up to the emit (or all)
    carries = popcount[(bottom2 >> 24) >> (8 - j)]
    shifted = (bottom2 << j) & 0xFFFFFFFF
    byte = shifted >> 24
    bottom3 = torch.where(emitted, (shifted & 0xFFFFFF) << (s - j), shifted)
    bit_num3 = torch.where(emitted, 8 - (s - j), bit_num - s)
    new = (torch.where(ok, bottom3, bottom), torch.where(ok, rng2 << s, rng),
           torch.where(ok, bit_num3, bit_num))
    return new, (byte, emitted & ok, torch.where(ok, carries, 0))


def _resolve_carries(ebytes, eflags, ecarr, max_bytes: int):
    """(lead [L], digits [L, max_bytes]) from the per-step bytes, emit
    flags and carry counts [L, T]: the k-th digit is the k-th emitted byte
    plus the carries that arrived while it was the newest, then the carries
    out of each digit run toward the front (carry lookahead); carries before
    the first byte ride a lead digit."""
    L, T = ebytes.shape
    dev = ebytes.device
    cs = torch.cumsum(eflags.to(torch.int64), dim=1)
    csc = torch.cumsum(ecarr, dim=1)
    ks = torch.arange(1, max_bytes + 1, device=dev).expand(L, max_bytes).contiguous()
    idx = torch.searchsorted(cs, ks)  # the step of the k-th emit
    ok = idx < T
    gi = idx.clamp(max=T - 1)
    digits = torch.where(ok, ebytes.gather(1, gi), 0)
    at_k = torch.where(ok, csc.gather(1, gi), csc[:, -1:])
    addend = torch.cat([at_k[:, 1:], csc[:, -1:]], dim=1)[:, :max_bytes] - at_k
    early = at_k[:, 0] if max_bytes > 0 else csc[:, -1]
    s = torch.cat([early[:, None], digits + addend], dim=1)  # [L, 1 + max_bytes]
    n = s.shape[1]
    pos = torch.arange(n, device=dev).expand(L, n)
    # A digit's carry in is the carry out of the first digit after it that
    # does not propagate (s != 255): generated when that digit is >= 256.
    stop = torch.where(s != 255, pos, n)
    first_stop = torch.flip(torch.cummin(torch.flip(stop, [1]), dim=1).values, [1])
    nxt = torch.cat([first_stop[:, 1:], torch.full((L, 1), n, device=dev)], dim=1)
    carry_in = torch.where(nxt < n, (s >= 256).to(torch.int64).gather(1, nxt.clamp(max=n - 1)),
                           0)
    out = (s + carry_in) & 0xFF
    return out[:, 0], out[:, 1:].to(torch.uint8)


def bool_encode_lanes_plain(bits, probs, valid, max_bytes: int, init_state=None) -> Lanes:
    """Torch twin of K15 (any device): streams [T, L] (valid == 0 steps are
    no-ops); `init_state` per-lane (bottom, range, bit_num) [L] to continue
    an encoder, else a fresh coder's."""
    T, L = bits.shape
    dev = bits.device
    norm = torch.from_numpy(_NORM).to(dev)
    popcount = torch.from_numpy(_POPCOUNT).to(dev)
    state = tuple(torch.as_tensor(x, device=dev).to(torch.int64).expand(L).clone()
                  for x in (INIT_STATE if init_state is None else init_state))
    bits, probs = bits.to(torch.int64), probs.to(torch.int64)
    valid = valid != 0
    steps = max(T, 1)  # an empty stream still resolves to a state and no bytes
    ebytes = torch.zeros((steps, L), dtype=torch.int64, device=dev)
    eflags = torch.zeros((steps, L), dtype=torch.bool, device=dev)
    ecarr = torch.zeros((steps, L), dtype=torch.int64, device=dev)
    for t in range(T):
        state, (ebytes[t], eflags[t], ecarr[t]) = _apply_op(state, bits[t], probs[t], valid[t],
                                                             norm, popcount)
    lead, data = _resolve_carries(ebytes.T, eflags.T, ecarr.T, max_bytes)
    n_bytes = eflags.sum(0)
    return Lanes(lead, data, n_bytes, *state, valid.sum(0))


class LaneCoderPlain:
    """One lane of `csrc/boolenc.cuh`'s coder in Python integers."""

    def __init__(self, state, cap: int):
        self.bottom, self.range, self.bit_num = (int(x) for x in state)
        self.cap, self.n, self.ops = cap, 0, 0
        self.out = bytearray(cap)
        self.marks = []  # q: a carry into bytes [0, q)

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        b2 = (self.bottom + split) & 0xFFFFFFFF if bit else self.bottom
        r2 = self.range - split if bit else split
        s = 8 - r2.bit_length()  # clz(r2) - 24 for r2 in 1..255
        self.range = r2 << s
        emit = self.bit_num <= s
        j = self.bit_num if emit else s
        t = (b2 << j) & 0xFFFFFFFF
        if emit:
            if self.n < self.cap:
                self.out[self.n] = t >> 24
            if b2 >> (32 - j) and self.n <= self.cap:
                self.marks.append(self.n)
            self.n += 1
        self.bottom = ((t & 0xFFFFFF) if emit else t) << (s - j)
        self.bit_num = self.bit_num + 8 - s if emit else self.bit_num - s
        self.ops += 1

    def finish(self):
        """(lead, bytes, n_bytes, bottom, range, bit_num, n_ops) after the
        carry marks are applied."""
        lead = 0
        for q in reversed(self.marks):
            i = q - 1
            while i >= 0 and self.out[i] == 0xFF:
                self.out[i] = 0
                i -= 1
            if i >= 0:
                self.out[i] += 1
            else:
                lead += 1
        return lead, bytes(self.out), self.n, self.bottom, self.range, self.bit_num, self.ops


def lane_coder_plain(bits, probs, valid, max_bytes: int, init_state=None) -> Lanes:
    """The device coder's step as a scalar twin (CPU): streams [T, L] as
    `bool_encode_lanes_plain` takes them, coded lane by lane."""
    T, L = bits.shape
    state = [torch.as_tensor(x).to(torch.int64).expand(L).tolist()
             for x in (INIT_STATE if init_state is None else init_state)]
    cols = [t.to(torch.int64).T.tolist() for t in (bits, probs, valid)]
    fields, data = [], torch.zeros((L, max_bytes), dtype=torch.uint8)
    for lane in range(L):
        c = LaneCoderPlain([x[lane] for x in state], max_bytes)
        for bit, prob, ok in zip(cols[0][lane], cols[1][lane], cols[2][lane]):
            if ok:
                c.put(bit, prob)
        lead, out, *rest = c.finish()
        fields.append([lead, *rest])
        if max_bytes:
            data[lane] = torch.frombuffer(bytearray(out), dtype=torch.uint8)
    info = torch.tensor(fields, dtype=torch.int64).reshape(L, 6)
    return Lanes.from_fields(info, data)


def bool_encode_lanes(bits, probs, valid, max_bytes: int, init_state=None) -> Lanes:
    """Code per-lane op streams bits/probs/valid [T, L] (uint8 or wider;
    valid == 0 steps are no-ops) into at most `max_bytes` bytes a lane:
    K15 for CUDA tensors, the plain twin for CPU ones."""
    dev = _build.same_device(bits, probs, valid)
    if dev.type == "cpu":
        return bool_encode_lanes_plain(bits, probs, valid, max_bytes, init_state)
    return _bool_lanes_kernel(bits, probs, valid, max_bytes,
                              INIT_STATE if init_state is None else init_state)


def _bool_lanes_kernel(bits, probs, valid, max_bytes: int, init_state) -> Lanes:
    dev = bits.device
    T, L = bits.shape
    state = torch.stack([torch.as_tensor(x, device=dev).to(torch.int64).expand(L)
                         for x in init_state], dim=-1).contiguous()
    streams = [t.to(torch.uint8).contiguous() for t in (bits, probs, valid != 0)]
    info = torch.empty((L, 6), dtype=torch.int64, device=dev)
    data = torch.zeros((L, max_bytes), dtype=torch.uint8, device=dev)
    carries = torch.empty((L, carry_words(max_bytes)), dtype=torch.int32, device=dev)
    _build.launch("bool_lanes", "webp_bool_lanes", dev,
                  *(_build.dense(t, torch.uint8, (T, L)) for t in streams), T, L,
                  _build.dense(state, torch.int64, (L, 3)), max_bytes, data.data_ptr(),
                  carries.data_ptr(), info.data_ptr())
    return Lanes.from_fields(info, data)
