"""Readings that set a cell's limits: the program's numbers and, beside
them, those of the reference put in the program's place at lower
precision (the control) and, in training, with half of the batch left
out. One process runs every seed; each is a whole run of the cell at its
own size (set-up, the first steps or a short window, the reference).

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

prints one JSON line a seed: ``program`` (the numbers ``correct`` is
decided on), and ``variants``: ``control`` (fp8 operands in the
aggregation, TF32 GEMMs) and, in training, ``half_batch`` and ``frozen``
(steps that leave the state unchanged). The benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys


def variants(kind: str) -> dict:
    from portbench.reference.common import CONTROL, EXACT

    out = {"control": {"prec": CONTROL}}
    if kind == "train":
        out["half_batch"] = {"prec": EXACT, "half": True}
        out["frozen"] = {"prec": EXACT, "frozen": True}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench import run as R

    if not torch.cuda.is_available():
        R.log("needs a CUDA device")
        return 2
    bench = R._json(os.path.join(R.ROOT, "BENCHMARK.json"))
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    kind = R._json(os.path.join(R.HERE, "traffic", f"{cell['traffic']}.json"))["kind"]
    for seed in args.seeds:
        out = R.run_cell(bench, cell, seed, args.seconds, False, torch.device("cuda"),
                         variants=variants(kind))
        line = dict(workload=args.workload, seed=seed, correct=out["correct"],
                    program={k: c["value"] for k, c in out["checks"].items()},
                    variants=out["variants"], metrics=out["metrics"])
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
