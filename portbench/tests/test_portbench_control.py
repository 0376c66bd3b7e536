"""The control at a small size: the reference put in the program's place
at one step lower precision (fp8 operands in the aggregation, TF32
GEMMs) fails at least one of the cell's limits, reading at
least three times what the program reads there. (The limits are set at
the cells' own size, where a loss averages over 2^20 nodes' rows; here,
over a few thousand, the program's own readings are larger and are not
held to them.) On the chip the same is measured at the cells' own sizes
with ``python3 -m portbench.control``."""

import pytest

from portbench import control
from portbench.tests.conftest import small_run


@pytest.mark.parametrize("cell", ["gcn-products.train", "gcn-products.infer"])
def test_control_fails_and_program_passes(cell):
    kind = cell.split(".")[1]
    out = small_run(cell, seed=21, variants={"control": control.variants(kind)["control"]})
    ctl = out["variants"]["control"]
    failed = [k for k, c in out["checks"].items() if ctl[k] > c["limit"] and ctl[k] >= 3 * c["value"]]
    assert failed, (ctl, out["checks"])
