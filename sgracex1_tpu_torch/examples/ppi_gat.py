"""Inductive multi-label GAT (the PPI protocol): a 2-layer GAT with sigmoid
BCE trained over several graphs, micro-F1 on whole held-out graphs. Reads
the real PPI files from a directory when one is given, else a synthetic
analogue with the same task structure.

    python -m sgracex1_tpu_torch.examples.ppi_gat [DATA_DIR] [--epochs 100] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.config import SGRACEConfig
from sgracex1_tpu_torch.graph.datasets import load_ppi, synthetic_ppi
from sgracex1_tpu_torch.nn.models import GATModel
from sgracex1_tpu_torch.train.loop import train_multilabel_inductive


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=None, help="directory of the PPI files")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--graphs", type=int, default=8, help="synthetic graphs (without ROOT)")
    ap.add_argument("--nodes", type=int, default=None, help="nodes a synthetic graph (default: PPI's)")
    ap.add_argument("--device", default=None, help="cpu, or the CUDA card (default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.root is not None:
        tr, va, te = (load_ppi(args.root, s) for s in ("train", "valid", "test"))
        print(f"PPI from {args.root}: {len(tr)}/{len(va)}/{len(te)} graphs")
    else:
        kw = {} if args.nodes is None else dict(n_per=args.nodes)
        tr, va, te = synthetic_ppi(num_graphs=args.graphs, splits=(2, 2), **kw)
        print("synthetic PPI analogue (pass a data directory for the real files)")
    g = tr[0]
    model = GATModel(g.num_features, 64, g.num_labels, nheads=4, dropout=0.0,
                     generator=torch.Generator().manual_seed(0))
    cfg = SGRACEConfig(num_epochs=args.epochs, learning_rate=0.005)
    state, hist = train_multilabel_inductive(model, tr, va, te, cfg, log_every=10, device=device)
    print(f"best val micro-F1 {hist.best_test_acc:.4f}")
    print(f"final test micro-F1 {hist.test_acc[-1]:.4f}")
    return state, hist


if __name__ == "__main__":
    main()
