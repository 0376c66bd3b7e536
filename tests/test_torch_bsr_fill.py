"""The last ported functions of sgracex1_tpu_torch.ops.bsr against
sgracex1_tpu.ops.bsr: ``bsr_spmm_xla``, the mask pack ``pack_mask_bsr``
with its unpacks, and the sticky tile padding ``pad_bsr_tile_count``
(identical arrays; the live schedules of the padded tiles equal the
unpadded ones)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sgracex1_tpu.ops import bsr as jb
from sgracex1_tpu_torch.ops import bsr as tb_

from test_torch_bsr import _assert_same_bsr, _graphs

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


@pytest.mark.parametrize("form", ["f32", "bf16", "mask"])
def test_bsr_spmm_xla_matches_jax(form):
    """The bf16 tolerance of the JAX package's own test of
    ``bsr_spmm_xla`` (tests/test_bsr.py), against JAX and the plain K1."""
    J, T = _graphs(n=1500, weighted=form != "mask", seed=4)
    if form == "mask":
        a, b = jb.bsr_mask_from_sparse(J, tb=128), tb_.bsr_mask_from_sparse(T, tb=128)
    else:
        jd, td = (jnp.bfloat16, torch.bfloat16) if form == "bf16" else (jnp.float32, torch.float32)
        a = jb.bsr_from_sparse(J, tb=128, dtype=jd, device_build=False)
        b = tb_.bsr_from_sparse(T, tb=128, dtype=td)
    H = np.random.default_rng(5).standard_normal((1500, 64)).astype(np.float32)
    want = np.asarray(jb.bsr_spmm_xla(a, jnp.asarray(H)))
    got = tb_.bsr_spmm_xla(b, torch.from_numpy(H))
    assert got.dtype == torch.float32 and got.shape == (1500, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)
    # the same bf16 products as the plain K1, summed in another order
    torch.testing.assert_close(got, tb_.bsr_spmm_plain(b, torch.from_numpy(H)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("batch_tiles", [None, 1, 3])
def test_pack_mask_bsr_matches_jax_and_bitmask(batch_tiles):
    J, T = _graphs(n=2500, weighted=False, seed=6)
    kw = dict(tb=1024, cover_rows=True, cover_cols=True)
    ja, ta = jb.bsr_mask_from_sparse(J, **kw), tb_.bsr_mask_from_sparse(T, **kw)
    jp = jb.pack_mask_bsr(ja, batch_tiles=batch_tiles)
    tp = tb_.pack_mask_bsr(ta, batch_tiles=batch_tiles)
    assert tp.tiles.dtype == torch.uint8 and tp.tiles.shape == (ta.num_tiles, 1024, 128)
    np.testing.assert_array_equal(np.asarray(jp.tiles), tp.tiles.numpy())
    assert torch.equal(tp.tiles, tb_.bsr_bitmask_from_sparse(T, **kw).tiles)
    # the layout and the schedules stay those of the mask tiles
    assert tp.ring is ta.ring and torch.equal(tp.live, ta.live)
    # both unpacks round-trip, and match JAX's on the same bytes
    assert torch.equal(tb_.unpack_mask01_tile(tp.tiles, 1024), ta.tiles.float())
    assert torch.equal(tb_.unpack_mask01_tile(tp.tiles, 1024, torch.bfloat16), ta.tiles.to(torch.bfloat16))
    assert torch.equal(tb_.unpack_mask_tile(tp.tiles, 1024), ta.tiles > 0)
    np.testing.assert_array_equal(
        np.asarray(jb.unpack_mask_tile(jnp.asarray(tp.tiles[0].numpy()), 1024)),
        tb_.unpack_mask_tile(tp.tiles[0], 1024).numpy(),
    )


def test_pack_mask_bsr_refuses_other_tiles():
    _, T = _graphs(n=600, weighted=False, seed=7)
    with pytest.raises(ValueError):
        tb_.pack_mask_bsr(tb_.bsr_mask_from_sparse(T, tb=64))
    with pytest.raises(ValueError):
        tb_.pack_mask_bsr(tb_.bsr_bitmask_from_sparse(T, tb=128))


@pytest.mark.parametrize("mask", [False, True])
def test_pad_bsr_tile_count_matches_jax(mask):
    J, T = _graphs(n=2000, weighted=not mask, seed=8)
    kw = dict(tb=128, cover_rows=True, cover_cols=True)
    if mask:
        a, b = jb.bsr_mask_from_sparse(J, **kw), tb_.bsr_mask_from_sparse(T, **kw)
    else:
        a = jb.bsr_from_sparse(J, dtype=jnp.bfloat16, device_build=False, **kw)
        b = tb_.bsr_from_sparse(T, **kw)
    b.live_t  # a cached schedule built before the padding is carried over
    T0 = b.num_tiles
    assert tb_.pad_bsr_tile_count(b, T0) is b
    pa, pb = jb.pad_bsr_tile_count(a, T0 + 9), tb_.pad_bsr_tile_count(b, T0 + 9)
    _assert_same_bsr(pa, pb)
    assert not pb.live[T0:].any() and torch.equal(pb.live[:T0], b.live)
    assert pb.ring is b.ring and pb.__dict__["live_t"] is b.live_t
    # the single-stage kernels' schedules take the pad tiles in
    assert int(pb.segments.seg_hi.max()) == T0 + 9 and pb.col_perm.shape[0] == T0 + 9
    H = torch.from_numpy(np.random.default_rng(9).standard_normal((2000, 64)).astype(np.float32))
    assert torch.equal(tb_.bsr_spmm_plain(pb, H), tb_.bsr_spmm_plain(b, H))
    assert torch.equal(tb_.bsr_spmm_xla(pb, H), tb_.bsr_spmm_xla(b, H))
