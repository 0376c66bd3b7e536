"""quant/affine and quant/calibration of the port against the JAX package:
every affine function bit for bit (array_equal, no tolerance) at 1/2/4/8
bits on grids that hold exact ties, values at and past the clamps and
negatives, in float32 and on bf16 values (the tile dtype); the calibration
tables field for field."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sgracex1_tpu.quant import affine as ja
from sgracex1_tpu.quant import calibration as jc
from sgracex1_tpu_torch.quant import affine as ta
from sgracex1_tpu_torch.quant import calibration as tc

torch.set_num_threads(1)

QBITS = [1, 2, 4, 8]


def _consts(qbits):
    """(name, JAX constants, port constants) of the table at ``qbits``,
    with one asymmetric range so that z != 0 is covered."""
    j, t = jc.CalibrationTable.for_qbits(qbits), tc.CalibrationTable.for_qbits(qbits)
    kw = dict(signed=True, w_qbits=qbits)
    out = [(n, getattr(j, n), getattr(t, n)) for n in ("weights", "features", "adjacency", "grad_out")]
    out.append(("asym", ja.generate_constants(-0.3, 0.9, qbits, **kw), ta.generate_constants(-0.3, 0.9, qbits, **kw)))
    return out


def _grid(c, rng):
    """Exact ties of the grid, the clamps and past them, negatives, zeros."""
    k = np.arange(c.alpha_q - 3, c.beta_q + 4, dtype=np.float64)
    ties = ((k + 0.5) - c.z) * c.s
    pts = (k - c.z) * c.s
    x = np.concatenate([ties, pts, -ties, [0.0, -0.0, 1e-9, -1e-9, 1e3, -1e3],
                        rng.uniform(-1.5, 1.5, 257)])
    return x.astype(np.float32)


def _same(a_torch, a_jax):
    a = a_torch.detach().to(torch.float32).numpy()
    b = np.asarray(a_jax.astype(jnp.float32))
    np.testing.assert_array_equal(a, b)
    if not a_jax.weak_type:  # a weakly typed JAX result takes its neighbour's dtype
        assert str(a_torch.dtype).split(".")[-1] == str(a_jax.dtype)


@pytest.mark.parametrize("qbits", QBITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine_functions_bit_equal(qbits, dtype):
    rng = np.random.default_rng(qbits)
    for name, cj, ct in _consts(qbits):
        assert dataclasses.asdict(cj) == dataclasses.asdict(ct), name
        assert (cj.alpha_q, cj.beta_q) == (ct.alpha_q, ct.beta_q)
        x = _grid(cj, rng)
        xj = jnp.asarray(x).astype(dtype)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        _same(ta.quantize(xt, ct), ja.quantize(xj, cj))
        _same(ta.dequantize(ta.quantize(xt, ct), ct), ja.dequantize(ja.quantize(xj, cj), cj))
        for st in (False, True):
            _same(ta.fake_quant_signed(xt, ct, qbits, straight_through=st),
                  ja.fake_quant_signed(xj, cj, qbits, straight_through=st))
            _same(ta.fake_quant_unsigned(xt, ct, qbits, straight_through=st),
                  ja.fake_quant_unsigned(xj, cj, qbits, straight_through=st))


@pytest.mark.parametrize("qbits", QBITS)
def test_internal_fixed_point_bit_equal(qbits):
    raw = jc.CalibrationTable.for_qbits(qbits).raw
    sf, iq = raw["scale_fea"], raw["internal_quantization"]
    lim = (2.0**iq - 1.0) / (2.0**iq) * 2.0**sf
    rng = np.random.default_rng(10 + qbits)
    # values that straddle the clamp, decimal ties of the rounding, noise
    d = 10.0 ** -(iq - 1)
    x = np.concatenate([
        lim * np.array([0.999999, 1.0, 1.000001, 2.0, -0.999999, -1.0, -1.000001, -2.0]),
        (np.arange(-40, 41) + 0.5) * d * 2.0**sf,
        rng.normal(0, 3, 500), rng.normal(0, 1e-3, 100), [0.0],
    ]).astype(np.float32)
    for st in (False, True):
        _same(ta.internal_fixed_point(torch.from_numpy(x), sf, iq, straight_through=st),
              ja.internal_fixed_point(jnp.asarray(x), sf, iq, straight_through=st))


@pytest.mark.parametrize("qbits", QBITS)
def test_ste_gradient_is_identity(qbits):
    cj, ct = jc.CalibrationTable.for_qbits(qbits).weights, tc.CalibrationTable.for_qbits(qbits).weights
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 64).astype(np.float32)
    w = np.random.default_rng(1).normal(size=64).astype(np.float32)
    gj = jax.grad(lambda v: jnp.sum(ja.fake_quant_signed(v, cj, qbits) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (ta.fake_quant_signed(xt, ct, qbits) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(xt.grad.numpy(), w)
    # ste(x, q): forward x + (q - x), gradient to x only
    q = torch.from_numpy(w)
    y = ta.ste(xt, q)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ja.ste(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("qbits", QBITS)
def test_generate_constants_field_equal(qbits, signed):
    for w_qbits in QBITS:
        for lo, hi in ((-1.0, 1.0), (0.0, 1.0), (-0.1, 0.1), (0.0, 0.37), (-0.3, 0.9), (-2.5, 0.25)):
            a = ja.generate_constants(lo, hi, qbits, signed=signed, w_qbits=w_qbits)
            b = ta.generate_constants(lo, hi, qbits, signed=signed, w_qbits=w_qbits)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    # the zero point truncates toward zero, and 1 bit divides by 4
    c = ta.generate_constants(-0.3, 0.9, 8, signed=True, w_qbits=1)
    assert c.z == int((0.9 * -127 - -0.3 * 127) / 1.2) and c.s_o == 1.2 / (254 / 4)


def _table_dict(t):
    return dataclasses.asdict(t)


@pytest.mark.parametrize("qbits", QBITS)
def test_calibration_table_field_equal(qbits):
    j, t = jc.CalibrationTable.for_qbits(qbits), tc.CalibrationTable.for_qbits(qbits)
    assert _table_dict(j) == _table_dict(t)
    for i in (0, 1, 2):
        assert dataclasses.asdict(j.layer_params(i)) == dataclasses.asdict(t.layer_params(i))
    ov = dict(w_min=-0.5, w_max=0.5, a_max=0.3, scale_fea=2)
    assert _table_dict(jc.CalibrationTable.for_qbits(qbits, ov)) == _table_dict(tc.CalibrationTable.for_qbits(qbits, ov))
    kw = dict(f_max=0.7, f_max2=3.1, w_absmax=0.41, w_absmax2=0.9, a_max=0.25)
    assert _table_dict(j.calibrate_from_amax(**kw)) == _table_dict(t.calibrate_from_amax(**kw))
    assert _table_dict(j.calibrate_from_amax(a_max=0.5)) == _table_dict(t.calibrate_from_amax(a_max=0.5))
    assert tc._TABLES == jc._TABLES and tc.GO_QBITS == jc.GO_QBITS


def test_unsupported_qbits_raise():
    with pytest.raises(ValueError, match="unsupported w_qbits"):
        tc.CalibrationTable.for_qbits(3)
