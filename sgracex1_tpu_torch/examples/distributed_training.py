"""Distributed GNN training with the halo (boundary) exchange: a GAT + GCN
training step over a mesh of graph shards, layer 1 a halo-exchange GAT,
layer 2 a halo-exchange GCN, the parameters replicated, the graph's rows
and node arrays sharded. The mesh is the in-process one (every shard in
this process, on one device); ``parallel.init_multihost`` and
``global_mesh`` run the same layers one shard a rank.

    python -m sgracex1_tpu_torch.examples.distributed_training [--shards 4] [--epochs 30] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.graph.datasets import sbm_node_classification
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.parallel.halo import build_halo, dist_gat_layer_halo, dist_gnn_layer_halo
from sgracex1_tpu_torch.parallel.mesh import make_mesh
from sgracex1_tpu_torch.parallel.partition import pad_nodes


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--nheads", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--device", default=None, help="cpu, or the CUDA card (default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    S = args.shards
    mesh = make_mesh(S, device=device)
    print(f"mesh: {S} shards in-process on {device}")

    data = sbm_node_classification(n=args.nodes, num_classes=4, seed=0)
    A = sym_norm(data.edge_index, data.num_nodes)
    G, n_pad = build_halo(A, S, device=device)
    print(f"N={data.num_nodes} (pad {n_pad}), halo rows a shard: {G.n_shards * G.halo_len} vs all-gather {n_pad}")
    node = lambda a: torch.from_numpy(pad_nodes(a, n_pad)).to(device)
    x, y = node(data.x), node(data.y.astype(np.int64))
    masks = {k: node(getattr(data, f"{k}_mask").astype(np.float32)) for k in ("train", "test")}

    f, h, c, H = data.num_features, args.hidden, data.num_classes, args.nheads
    rng = np.random.default_rng(0)
    init = lambda *s: torch.from_numpy((rng.standard_normal(s) * (2.0 / s[0]) ** 0.5).astype(np.float32))
    params = {"W1": init(f, h * H), "att1": init(2 * h * H, 1), "W2": init(h * H, h), "Wo": init(h, c)}
    params = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(params.values(), lr=0.01, betas=(0.9, 0.999), eps=1e-8)

    def forward(p):
        hdn = dist_gat_layer_halo(mesh, G, x, mesh.replicated(p["W1"]), mesh.replicated(p["att1"]), relu=True,
                                  nheads=H)
        hdn = dist_gnn_layer_halo(mesh, G, hdn, mesh.replicated(p["W2"]), relu=True)
        return hdn @ p["Wo"]

    losses = []
    for epoch in range(args.epochs):
        opt.zero_grad(set_to_none=True)
        ls = F.cross_entropy(forward(params), y, reduction="none")
        loss = torch.sum(ls * masks["train"]) / torch.sum(masks["train"])
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if (epoch + 1) % 10 == 0 or epoch == 0:
            with torch.no_grad():
                pred = forward(params).argmax(-1)
                acc = float(torch.sum((pred == y) * masks["test"]) / torch.sum(masks["test"]))
            print(f"epoch {epoch + 1:03d} loss {losses[-1]:.4f} test acc {acc:.4f}")
    return losses


if __name__ == "__main__":
    main()
