"""MUTAG molecule graph classification, the reference's accuracy anchor:
188 MUTAG graphs split 150/38, a 2-layer GCN on the raw block-diagonal
adjacency (no normalization, no self-loops, as the notebook's layer),
hidden 64, global mean pool, dropout 0.5, Adam lr 0.01, full batch. The
reference reports 0.76 test accuracy around epoch 36.

    python -m sgracex1_tpu_torch.examples.molecule_gcn --data-root DIR [--seed 1] [--epochs 50] [--device cpu]

DIR (or the ``MUTAG_ROOT`` environment variable) holds MUTAG in the TU
format (``MUTAG/MUTAG_A.txt`` ...).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.config import SGRACEConfig
from sgracex1_tpu_torch.graph.batch import batch_graphs
from sgracex1_tpu_torch.graph.datasets import load_tu_dataset
from sgracex1_tpu_torch.nn.models import MoleculeGCN
from sgracex1_tpu_torch.train.loop import train_graph_classifier


def full_batch(graphs, pad_to: int = 128):
    n = sum(g.num_nodes for g in graphs)
    n_pad = (n + pad_to - 1) // pad_to * pad_to
    return [batch_graphs(graphs, n_pad=n_pad, g_pad=len(graphs) + 1, normalize=False)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--device", default=None, help="cpu, or the CUDA card (default)")
    args = ap.parse_args(argv)
    root = args.data_root or os.environ.get("MUTAG_ROOT")
    if root is None or not os.path.isdir(root):
        sys.exit("MUTAG data not found; pass --data-root or set MUTAG_ROOT")
    device = resolve_device(args.device)

    graphs = load_tu_dataset(root, "MUTAG")
    print(f"{len(graphs)} graphs, {graphs[0].x.shape[1]} features")
    idx = np.random.default_rng(args.seed).permutation(len(graphs))
    train = [graphs[i] for i in idx[:150]]
    test = [graphs[i] for i in idx[150:]]
    model = MoleculeGCN(graphs[0].x.shape[1], 64, 2, generator=torch.Generator().manual_seed(args.seed))
    cfg = SGRACEConfig(num_epochs=args.epochs, learning_rate=0.01)
    _, hist = train_graph_classifier(model, full_batch(train), full_batch(test), cfg, log_every=10, device=device)
    first = next((i + 1 for i, a in enumerate(hist.test_acc) if a >= 0.76), None)
    print(f"best test acc {hist.best_test_acc:.4f} (anchor 0.76 first hit at epoch {first})")
    return hist


if __name__ == "__main__":
    main()
