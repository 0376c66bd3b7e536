"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name from ``BENCHMARK.json``:
``portbench/configs/<config>.json`` (with ``portbench/families/<family>.py``,
``portbench/reference/<family>.py`` and the graph generator
``portbench/graphs/<generator>.py``), ``portbench/traffic/<traffic>.json``
(whose ``kind`` names its driver, ``portbench/drivers/<kind>.py``),
``portbench/metrics/<metric>.py`` (a reader: ``read(run)`` gives the number
or None) and ``portbench/limits/<cell>.json`` (the limit of each number
that decides ``correct``).

A run makes its graph, features and weights from the seed on the card,
runs the driver's set-up (the port's normalize and prepare), warms up, measures for
``--seconds``, checks what the window's path produced against the plain
reference, and prints one JSON line last on standard output. With
``--trace 1`` it also profiles a short stretch after the window and
reports the per-layer metrics instead of the end-to-end ones. It exits
with an error, and prints no result, without a CUDA card, or if JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
CACHE = os.path.join(HERE, "_cache")
FORBIDDEN = {"jax", "jaxlib", "flax", "sgracex1_tpu"}
PORT = "sgracex1_tpu_torch"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str):
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Run:
    """What one run of a cell knows: its settings, the set-up's parts, the
    inputs, the system under test while it lives, and the window's
    readings. Its traffic driver fills it; the readers read it."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device,
                 overrides: dict = None, traffic: dict = None):
        self.cfg = dict(_json(os.path.join(HERE, "configs", f"{cell['config']}.json")), **(overrides or {}))
        self.traffic = dict(_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")), **(traffic or {}))
        self.fam = importlib.import_module(f"portbench.families.{self.cfg['family']}")
        self.driver = importlib.import_module(f"portbench.drivers.{self.traffic['kind']}")
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.parts, self.numbers, self.latencies = {}, {}, []
        self.variants, self.variant_numbers = {}, {}
        self.traced, self.trace_units, self.units, self.window_s = None, 0, 0, 0.0
        self.memory_peak = 0
        self.log = log

    def seed_of(self, tag: str) -> int:
        """A seed for one purpose, derived from the run's seed."""
        h = hashlib.sha256(f"{self.seed}:{tag}".encode()).digest()
        return int.from_bytes(h[:8], "little") >> 1

    def start_window(self) -> None:
        self.setup_s = time.perf_counter() - T_START

    def read_memory(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    def least(self, kind=None) -> float:
        """Least seconds of one unit of the driver's work (an epoch, a
        request) at the card's peaks (``counts``)."""
        from portbench import counts

        return counts.least_time(self.driver.unit_ops(self), kind)


def _launches() -> dict:
    """``{entry: {counter: launches}}`` of every function of the port's
    loaded modules that counts its launches (``launches`` and its splits,
    such as ``launches_ring`` or ``launches_gather``)."""
    out = {}
    for modname, mod in sorted(sys.modules.items()):
        if modname.split(".")[0] != PORT or mod is None:
            continue
        for name, fn in vars(mod).items():
            if callable(fn) and getattr(fn, "__module__", None) == modname and getattr(fn, "launches", 0):
                out[f"{modname[len(PORT) + 1:]}.{name}"] = {
                    k: v for k, v in vars(fn).items() if k.startswith("launches") and isinstance(v, int)
                }
    return out


def setup(run: Run) -> None:
    """Inputs from the seed, then the driver's set-up (the port's prepare,
    the model)."""
    import torch

    from portbench import gen, trace
    from portbench.drivers import common

    run.own_kernels = trace.own_kernels(os.path.join(ROOT, PORT, "csrc"))
    common.timed(run, "import", lambda: importlib.import_module(PORT))
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    run.graph = common.timed(run, "generation", lambda: gen.graph(run.cfg, run.seed_of("graph"), run.device))
    g, n = run.graph, run.graph.num_nodes
    r, c = g.edges
    deg = torch.bincount(r, minlength=n)
    band = float((((r - c) % n) <= run.cfg["graph"].get("ring", 0)).double().mean()) * 2
    log(f"graph: {n} nodes, {r.numel()} directed edges without self-loops, mean degree {r.numel() / n:.4f}, "
        f"max {int(deg.max())}, median {float(deg.double().median()):.0f}; edge homophily "
        f"{float((g.y[r] == g.y[c]).double().mean()):.4f}; ring band share {band:.4f}")
    run.edges_host = g.edges.cpu().numpy()
    run.n_edges = run.edges_host.shape[1]
    g.edges = None
    del r, c, deg
    run.driver.setup(run)
    log(f"CSR nnz with the self-loops {run.nnz}")


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def _readers(bench: dict, cell: str, per_layer: bool):
    """The metrics this run reports, with their readers."""
    out = []
    for m in bench["per_layer" if per_layer else "end_to_end"]:
        if cell in m.get("workloads", [cell]):
            out.append((m, _module(os.path.join(HERE, "metrics", f"{m['name']}.py"))))
    return out


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
             overrides: dict = None, variants: dict = None, traffic: dict = None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``overrides`` / ``traffic`` replace keys of the configuration / mix
    (the CPU tests' small sizes); ``variants`` as ``portbench/drivers/``
    says, their numbers returned under ``variants``."""
    import torch

    run = Run(cell, seed, seconds, trace, device, overrides, traffic)
    run.variants = variants or {}
    setup(run)
    run.driver.drive(run)
    log("launches by ops entry: " + json.dumps(_launches()))
    log("set-up parts (s): " + json.dumps({k: round(v, 4) for k, v in run.parts.items()}))
    log(f"host peak resident memory {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
    log(f"least time of one unit of {run.traffic['kind']} at the peaks: "
        f"{run.least() * 1e3:.4f} ms, of it the port's kernels' work {run.least('kernel') * 1e3:.4f} ms")
    metrics = {}
    for m, reader in _readers(bench, cell["name"], trace):
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    limits = _json(os.path.join(HERE, "limits", f"{cell['name']}.json"))
    for k in sorted(set(run.numbers) - set(limits)):
        if k == "by_leaf":
            log("readings by step and leaf: " + json.dumps(run.numbers[k]))
        else:
            log(f"reading {k} {run.numbers[k]!r}, not compared (see PERF.md)")
    for name, nums in run.variant_numbers.items():
        log(f"variant {name}: " + json.dumps(nums))
    checks = {k: {"value": run.numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())  # NaN fails
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak}
    out = {"correct": correct, "attempted": run.units, "failed": 0, "metrics": metrics, "device": dev}
    if trace and run.traced:
        dev["busy_s"] = run.traced["busy_s"]
        dev["window_s"] = run.traced["window_s"]
        out["breakdown"] = {k: run.traced[k] for k in ("device_ops", "idle_gaps")}
        log("traced stretch: " + json.dumps({k: run.traced[k] for k in (
            "busy_s", "window_s", "device_s", "own_s", "other_s", "n_device_ops")}))
    if run.variant_numbers:
        out["variants"] = run.variant_numbers
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        log(f"unknown workload {args.workload!r}; known: {sorted(cells)}")
        return 2
    cell = cells[args.workload]
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules of JAX or the JAX package: {bad}")
        return 3
    for k, c in out["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
