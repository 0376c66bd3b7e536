"""Driver entry points, as the JAX package's ``__graft_entry__``:
``entry()`` gives the flagship GAT model's forward and its arguments, and
run as a module it runs that forward and the distributed dry run
(``parallel.dryrun``) under a deadline.

    python -m sgracex1_tpu_torch.graft_entry [--device cpu]

On the CUDA card by default; the dry run's tile kernels take tb 32 there
(the JAX dry run's tb 8 runs on the CPU only).
"""

from __future__ import annotations

import argparse

import torch

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.graph.datasets import sbm_node_classification
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.nn.models import GATModel
from sgracex1_tpu_torch.ops.dispatch import prepare_adjacency

DEADLINE_S = 420.0
DRYRUN_SHARDS = 4


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` is the forward of ``GATModel(64, 16, 5,
    nheads=2)`` (weights from a generator seeded 0, eval mode) on the
    stochastic-block-model graph of the JAX entry (n 512, 64 features, 5
    classes, seed 0), sym-normalized and prepared with ``for_gat`` on
    ``device`` (the CUDA card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    data = sbm_node_classification(n=512, num_classes=5, num_features=64, seed=0)
    A = sym_norm(data.edge_index, data.num_nodes)
    prep = prepare_adjacency(A, for_gat=True, device=device)
    x = torch.from_numpy(data.x).to(device)
    model = GATModel(data.num_features, 16, data.num_classes, nheads=2,
                     generator=torch.Generator().manual_seed(0)).to(device).eval()

    def fn(model, A, x):
        with torch.no_grad():
            return model(A, x)

    return fn, (model, prep, x)


def main(argv=None) -> None:
    from sgracex1_tpu_torch.parallel.dryrun import dryrun_multichip
    from sgracex1_tpu_torch.utils.watchdog import run_with_deadline

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the CUDA card (default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def gate():
        fn, fargs = entry(device)
        out = fn(*fargs)
        if not torch.isfinite(out).all():
            raise AssertionError("entry: non-finite logits")
        print("entry ok:", tuple(out.shape))
        loss, _, _ = dryrun_multichip(DRYRUN_SHARDS, tb=32 if device.type == "cuda" else 8, device=device)
        print(f"dryrun_multichip ok: {DRYRUN_SHARDS} shards on {device}, loss {float(loss):.4f}")

    run_with_deadline(gate, DEADLINE_S)


if __name__ == "__main__":
    main()
