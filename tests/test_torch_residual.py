"""K1 (levels -> residuals): the port's plain path against the JAX package.

One host parse (`webp_tpu_torch.decode.device.parse_levels_batch`) feeds
both sides.  The JAX side is `_device_decode_sparse8`'s expand + escape
scatter followed by `_decode_core`'s dequant / Y2 IWHT fold / IDCT and
do_sub (webp_tpu/decode/device.py:483-552), written out with the JAX
package's own functions.  Tolerance: bit-exact (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import jax_ops
from webp_tpu.ops.sparse import device_expand_levels_mb, host_pack_levels_mb as jax_host_pack
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.ops import residual, sparse

from torch_fixtures import force_escapes, mixed_payloads

W, H = 72, 40


@pytest.fixture(scope="module")
def batch():
    return tdev.parse_levels_batch(mixed_payloads(W, H, seeds=(11, 12)))


def _jax_residuals(b, nmb):
    B = b["bitmap"].shape[0]
    lv = (
        device_expand_levels_mb(jnp.asarray(b["bitmap"]), jnp.asarray(b["vals"]), nmb, 400)
        .reshape(B, nmb * 400)
        .astype(jnp.int16)
    )
    lv = lv.at[jnp.arange(B)[:, None], jnp.asarray(b["esc_pos"])].set(
        jnp.asarray(b["esc_val"]), mode="drop"
    )
    levels = lv.reshape(B, nmb, 25, 16)
    qtab = jnp.asarray(b["qtab"]).reshape(B, 4, 25, 16).astype(jnp.int32)
    f = tdev.field_views(b["u8buf"], nmb)
    sid = jnp.asarray(f["segment_ids"]).astype(jnp.int32)
    q = jnp.zeros((B, nmb, 25, 16), jnp.int32)
    for s in range(4):
        q = q + jnp.where((sid == s)[..., None, None], qtab[:, s][:, None], 0)
    deq = levels.astype(jnp.int32) * q
    y2 = jax_ops.iwht4x4(deq[:, :, 24, :])
    lm = jnp.asarray(f["luma_mode"]).astype(jnp.int32)
    dcs = jnp.where((lm != 4)[..., None], y2, deq[:, :, :16, 0])
    coeffs = deq[:, :, :24, :].at[:, :, :16, 0].set(dcs)
    res = jax_ops.idct4x4(coeffs)
    do_sub = (lm == 4) | (
        ~jnp.asarray(f["skipped"]).astype(bool) & jnp.asarray(f["non_zero"]).astype(bool)
    )
    return np.asarray(res), np.asarray(do_sub)


def _port_residuals(b, dense=False):
    if dense:
        b = dict(b, bitmap=None)
    d = tdev.to_device_batch(b, "cpu")
    nmb = b["u8buf"].shape[1] // 24
    f = tdev.field_views(d["u8buf"], nmb)
    mb = (f["segment_ids"], f["luma_mode"], f["skipped"], f["non_zero"])
    if dense:
        return residual.residuals_dense(d["i16buf"], *mb)
    return residual.residuals_sparse(
        *(d[k] for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab")), *mb
    )


@pytest.mark.parametrize("forced", [False, True], ids=["encoded", "forced_escapes"])
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense_int16"])
def test_residuals_match_jax(batch, forced, dense):
    b = force_escapes(batch) if forced else batch
    assert b["bitmap"] is not None
    nmb = b["u8buf"].shape[1] // 24
    if forced:
        n_esc = (b["esc_pos"] < nmb * 400).sum(1)
        assert (n_esc >= 6).all() and (b["esc_pos"] == nmb * 400).any(1).all()
    want_res, want_ds = _jax_residuals(b, nmb)
    res, do_sub = _port_residuals(b, dense)
    assert res.dtype == torch.int32 and tuple(res.shape) == (2, nmb, 24, 16)
    np.testing.assert_array_equal(res.numpy(), want_res)
    np.testing.assert_array_equal(do_sub.numpy(), want_ds)


def test_expand_matches_jax_one_hot(batch):
    nmb = batch["u8buf"].shape[1] // 24
    want = device_expand_levels_mb(
        jnp.asarray(batch["bitmap"]), jnp.asarray(batch["vals"]), nmb, 400
    )
    got = sparse.expand_levels_mb(
        torch.from_numpy(batch["bitmap"]), torch.from_numpy(batch["vals"]), nmb, 400
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int16))


def test_host_pack_matches_jax_package():
    rng = np.random.RandomState(3)
    nmb = 12
    flat = (rng.randint(-128, 128, nmb * 400) * (rng.rand(nmb * 400) < 0.2)).astype(np.int8)
    for cap in (8, 256):
        got = sparse.host_pack_levels_mb(flat, nmb, 400, cap)
        want = jax_host_pack(flat, nmb, 400, cap)
        assert got[2] == want[2]
        np.testing.assert_array_equal(got[0], want[0])
        if want[2]:
            np.testing.assert_array_equal(got[1], want[1])


def test_escape_list_ascends_with_sentinels(batch):
    b = force_escapes(batch, seed=9)
    nmb = b["u8buf"].shape[1] // 24
    for row in b["esc_pos"]:
        assert (np.diff(row) >= 0).all()
        assert row[-1] == nmb * 400
