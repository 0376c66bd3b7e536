"""Adaptive affine quantization (1/2/4/8-bit), as
``sgracex1_tpu.quant.affine``, on torch tensors.

- ``quantize``: affine ``round(x/s + z)`` clamped to [alpha_q, beta_q]; the
  1-bit signed case is binary +-1.
- fake-quant variants for QAT emulation: the same rounding and clamping,
  then a rescale by ``2^-(w_qbits-1)`` that models the hardware's
  fixed-point insertion; the 1-bit variants give +-0.5 / {0, 0.5}.
- ``generate_constants``: scale and zero point, with the output scale
  ``s_o`` of the fixed-point alignment.
- ``internal_fixed_point``: the accelerator's internal pipeline after
  ``X @ W``: shift by ``scale_fea``, clamp to +-(2^iq - 1)/2^iq, round to
  iq-1 decimal digits.

Every function gives the JAX package's result bit for bit: ``torch.round``
rounds half to even as ``jnp.round`` does, every division stays a
division, and a Python scalar meets a tensor rounded to the tensor's own
dtype first (JAX's weak typing), which matters on bf16 tiles. The
fake-quant functions take straight-through gradients (``ste``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantConstants:
    """(s_o, s, z) triple for one tensor class.

    ``s`` / ``z`` are the affine scale and zero point; ``s_o`` is the
    output ("dequantization") scale that folds in the fixed-point alignment
    of the hardware pipeline.
    """

    s_o: float
    s: float
    z: int
    qbits: int
    signed: bool

    @property
    def alpha_q(self) -> int:
        if self.signed:
            return -1 if self.qbits == 1 else -(2 ** (self.qbits - 1)) + 1
        return 0

    @property
    def beta_q(self) -> int:
        if self.signed:
            return 1 if self.qbits == 1 else 2 ** (self.qbits - 1) - 1
        return 2**self.qbits - 1


def generate_constants(
    alpha: float, beta: float, qbits: int, *, signed: bool, w_qbits: int
) -> QuantConstants:
    """Scale, zero point and output scale of the range [alpha, beta].

    ``w_qbits`` is the *global* weight bit-width: the output scale ``s_o``
    follows it whatever this tensor's own ``qbits`` (1 bit divides by 4).
    The zero point truncates toward zero.
    """
    if signed:
        if qbits == 1:
            alpha_q, beta_q = -1, 1
        else:
            alpha_q, beta_q = -(2 ** (qbits - 1)) + 1, 2 ** (qbits - 1) - 1
    else:
        alpha_q, beta_q = 0, 2**qbits - 1

    div = 2**2 if w_qbits == 1 else 2**w_qbits
    beta_o = beta_q / div
    alpha_o = alpha_q / div

    s_o = (beta - alpha) / (beta_o - alpha_o)
    s = (beta - alpha) / (beta_q - alpha_q)
    z = int((beta * alpha_q - alpha * beta_q) / (beta - alpha))
    return QuantConstants(s_o=s_o, s=s, z=z, qbits=qbits, signed=signed)


def _weak(v, x: torch.Tensor) -> float:
    """A Python scalar rounded to ``x``'s dtype, as JAX's weak typing
    rounds it before the op: the same op then gives the same bits on the
    CPU (which casts the scalar) and on the card (which would keep it in
    float32 against a bf16 tensor)."""
    if x.dtype in (torch.float64, torch.float32) or not x.dtype.is_floating_point:
        return v  # float32 meets the scalar rounded to float32 either way
    return float(torch.tensor(v, dtype=torch.float64).to(x.dtype))


def _affine(x: torch.Tensor, c: QuantConstants) -> torch.Tensor:
    return x / _weak(c.s, x) + c.z


def quantize(x: torch.Tensor, c: QuantConstants) -> torch.Tensor:
    """Affine quantize to the integer grid (float-valued)."""
    if c.signed and c.qbits == 1:
        # +-1 in float32 whatever x's dtype, as the JAX function's result
        return torch.where(_affine(x, c) < 0, -1.0, 1.0)
    return torch.clamp(torch.round(_affine(x, c)), c.alpha_q, c.beta_q)


def dequantize(x_q: torch.Tensor, c: QuantConstants) -> torch.Tensor:
    return (x_q - c.z) * _weak(c.s, x_q)


def ste(x: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward = quantized, gradient = identity."""
    return x + (quantized - x).detach()


def _fake_quant_core(x: torch.Tensor, c: QuantConstants, w_qbits: int) -> torch.Tensor:
    xq = torch.clamp(torch.round(_affine(x, c)), c.alpha_q, c.beta_q)
    return xq / (2.0 ** (w_qbits - 1))


def fake_quant_signed(
    x: torch.Tensor, c: QuantConstants, w_qbits: int, *, straight_through: bool = True
) -> torch.Tensor:
    """Signed fake quant; 1-bit is binary +-0.5."""
    if c.qbits == 1:
        q = torch.where(_affine(x, c) < 0, -0.5, 0.5).to(x.dtype)
    else:
        q = _fake_quant_core(x, c, w_qbits)
    return ste(x, q) if straight_through else q


def fake_quant_unsigned(
    x: torch.Tensor, c: QuantConstants, w_qbits: int, *, straight_through: bool = True
) -> torch.Tensor:
    """Unsigned fake quant; 1-bit rounds and clips to {0, 1}, then halves."""
    if c.qbits == 1:
        q = torch.clamp(torch.round(_affine(x, c)), 0.0, 1.0) / 2.0
    else:
        q = _fake_quant_core(x, c, w_qbits)
    return ste(x, q) if straight_through else q


def internal_fixed_point(
    wh: torch.Tensor,
    scale_fea: int,
    internal_quantization: int,
    *,
    straight_through: bool = True,
) -> torch.Tensor:
    """The accelerator's internal fixed-point pipeline after ``X @ W``:
    shift right by ``scale_fea``, clamp to +-(2^iq - 1)/2^iq, round to iq-1
    decimal digits."""
    iq = internal_quantization
    q = wh / (2.0**scale_fea)
    lim = (2.0**iq - 1.0) / (2.0**iq)
    q = torch.clamp(q, -lim, lim)
    p = _weak(10.0 ** (iq - 1), wh)
    q = torch.round(q * p) / p
    return ste(wh, q) if straight_through else q
