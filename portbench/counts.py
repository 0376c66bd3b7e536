"""The yardstick's count of work: operations and bytes from the graph's
sizes and the configuration's widths, never from a layout the program
chose (tiles, chunks, padding and dead slots do not count).

An operation is ``(flops, bytes, kind)``. Each input byte is read once
and each output byte written once, at the widths the configuration states;
recompute is not counted. Its least time on the card is
``max(flops / PEAK_FLOPS, bytes / PEAK_BYTES)``, and a sequence's least
time is the sum over its operations. ``kind`` is ``"kernel"`` for the
aggregation work (the port's own kernels do it) and
``"torch"`` for the rest.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates: 989 TFLOP/s (bf16 tensor cores) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import List, NamedTuple

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

F32, BF16, I32, I64, BOOL = 4, 2, 4, 8, 1


class Op(NamedTuple):
    name: str
    flops: float
    bytes: float
    kind: str = "torch"


def least_time(ops: List[Op], kind: str = None) -> float:
    """Seconds the card needs at its peaks for ``ops`` (of ``kind`` only,
    where given)."""
    return sum(
        max(o.flops / PEAK_FLOPS, o.bytes / PEAK_BYTES) for o in ops if kind is None or o.kind == kind
    )


def gemm(name: str, m: int, k: int, n: int, item: int = F32) -> Op:
    """``[m, k] @ [k, n]``."""
    return Op(name, 2.0 * m * k * n, item * (m * k + k * n + m * n))


def elementwise(name: str, elems: int, reads: float, writes: float, flops_per: float = 1.0) -> Op:
    """An elementwise pass over ``elems`` entries reading ``reads`` and
    writing ``writes`` bytes an entry."""
    return Op(name, flops_per * elems, elems * (reads + writes))


def csr_bytes(n: int, nnz: int) -> float:
    """A CSR's row pointers, column indices and values."""
    return I32 * (n + 1) + nnz * (I32 + F32)


def aggregate(name: str, n: int, nnz: int, p: int) -> Op:
    """``A @ H`` over a CSR of ``nnz`` entries: H read once as a bf16
    operand, the f32 product written once."""
    return Op(name, 2.0 * nnz * p, csr_bytes(n, nnz) + n * p * (BF16 + F32), "kernel")


def adam(name: str, params: int) -> Op:
    """Adam over ``params`` f32 entries: reads parameter, gradient and both
    moments, writes parameter and moments."""
    return elementwise(name, params, 4 * F32, 3 * F32, 12.0)


def cross_entropy(name: str, n: int, c: int, backward: bool) -> Op:
    """Masked mean cross-entropy over ``n`` rows of ``c`` logits (labels
    and mask read once); its backward writes the logits' gradient."""
    reads = n * (c * F32 + I64 + F32)
    writes = n * c * F32 if backward else F32
    return Op(name, 4.0 * n * c, reads + writes)
