"""Shared helpers of the benchmark's CPU tests: a run of a cell at a small
size on the CPU, through the harness's own path after its look for a
card."""

import json
import os
import warnings

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# nodes of a cell's small run: where the port's cost model takes the kind
# it takes on the card at 2^20 (``pallas``, not ``dense``)
SMALL = 4096
QUICK = dict(min_epochs=1, estimate_epochs=3, min_requests=4, checked_requests=2)


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def small_run(cell: str, seed: int = 3, **kw) -> dict:
    from portbench import run as R

    b = bench()
    c = {w["name"]: w for w in b["workloads"]}[cell]
    return R.run_cell(b, c, seed, 0.1, False, torch.device("cpu"), overrides=dict(num_nodes=SMALL),
                      traffic=QUICK, **kw)
