"""One full distributed training step through every layer kind, at tiny
shapes: the twin of the JAX package's ``dryrun_multichip``.

The step chains the all-gather GAT layer, the halo GCN layer, the halo
layer with its local blocks on K1, the distributed flash GAT layer (K3
forward, K4/K5 backward under the merged stats), the halo layer on the
fused plans (K2 both ways) and an 8-bit fake-quantized halo layer
(straight-through gradients), then a linear head, masked cross-entropy
and one Adam step (lr 0.01), on a stochastic-block-model graph of 24
nodes a shard.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from sgracex1_tpu_torch.graph.datasets import sbm_node_classification
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.nn.convert import dist_params_from_jax
from sgracex1_tpu_torch.parallel.halo import (
    HaloBSRPlan,
    HaloGraph,
    build_halo,
    build_halo_bsr,
    dist_gat_layer_halo_flash,
    dist_gnn_layer_halo,
    dist_gnn_layer_halo_bsr,
)
from sgracex1_tpu_torch.parallel.halo_fused import HaloFusedPlan, build_halo_fused, dist_gnn_layer_halo_fused
from sgracex1_tpu_torch.parallel.mesh import Mesh, make_mesh
from sgracex1_tpu_torch.parallel.partition import ShardedGraph, pad_nodes, partition_graph
from sgracex1_tpu_torch.parallel.spmm_dist import dist_gat_layer
from sgracex1_tpu_torch.quant.affine import fake_quant_signed, fake_quant_unsigned, ste
from sgracex1_tpu_torch.quant.calibration import CalibrationTable, LayerQuantParams

HIDDEN = 16
PARAM_NAMES = ("W1", "att1", "W2", "W3", "W4", "att4", "W5", "W6", "Wo")


@dataclasses.dataclass(frozen=True)
class DryRunProblem:
    """The graph in every distributed layout, its padded node arrays on
    the mesh's device, and the 8-bit layer's quantization constants."""

    mesh: Mesh
    G: ShardedGraph
    HG: HaloGraph
    BP: HaloBSRPlan
    FPL: HaloFusedPlan
    x: torch.Tensor
    y: torch.Tensor
    m: torch.Tensor
    q: LayerQuantParams


def build_problem(n_shards: int, *, tb: int = 8, device=None) -> DryRunProblem:
    """The dry run's graph (``n_shards * 24`` nodes, 16 features, 3
    classes) and layouts: f32 value tiles for K1 and the flash layer, the
    fused plans at ``tb`` (and the port's K, 128, the JAX dry run's). On the card the tile kernels need
    tb % 32 == 0; the JAX dry run's tb = 8 runs on the CPU."""
    mesh = make_mesh(n_shards, device=device)
    data = sbm_node_classification(n=n_shards * 24, num_classes=3, num_features=16, seed=0)
    A = sym_norm(data.edge_index, data.num_nodes)
    G, n_pad = partition_graph(A, n_shards, device=mesh.device)
    HG, n_pad_h = build_halo(A, n_shards, device=mesh.device)
    if n_pad_h != n_pad:
        raise AssertionError(f"halo n_pad {n_pad_h} != partition n_pad {n_pad}")
    t = lambda a: torch.from_numpy(pad_nodes(a, n_pad)).to(mesh.device)
    return DryRunProblem(
        mesh=mesh, G=G, HG=HG, BP=build_halo_bsr(HG, tb=tb, dtype=torch.float32),
        FPL=build_halo_fused(HG, tb=tb),
        x=t(data.x), y=t(data.y.astype(np.int64)), m=t(data.train_mask.astype(np.float32)),
        q=CalibrationTable.for_qbits(8).layer_params(0),
    )


def init_params(f: int = 16, h: int = HIDDEN, c: int = 3) -> "OrderedDict[str, np.ndarray]":
    """The dry run's parameters: standard normals from ``default_rng(0)``
    times 0.1, drawn in the JAX dry run's order."""
    rng = np.random.default_rng(0)
    shapes = dict(W1=(f, h), att1=(2 * h, 1), W2=(h, h), W3=(h, h), W4=(h, h), att4=(2 * h, 1),
                  W5=(h, h), W6=(h, h), Wo=(h, c))
    return OrderedDict(
        (k, (rng.standard_normal(shapes[k]).astype(np.float32) * 0.1)) for k in PARAM_NAMES
    )


def loss_fn(P: DryRunProblem, p: dict) -> torch.Tensor:
    """The dry run's loss: six distributed layers, the head, masked
    cross-entropy over the padded rows."""
    mesh, q = P.mesh, P.q
    hdn = dist_gat_layer(mesh, P.G, P.x, p["W1"], p["att1"], relu=True)
    hdn = dist_gnn_layer_halo(mesh, P.HG, hdn, p["W2"], relu=True)
    hdn = dist_gnn_layer_halo_bsr(mesh, P.HG, P.BP, hdn, p["W3"], relu=True)
    hdn = dist_gat_layer_halo_flash(mesh, P.HG, P.BP, hdn, p["W4"], p["att4"], relu=True)
    hdn = dist_gnn_layer_halo_fused(mesh, P.HG, P.FPL, hdn, p["W6"], relu=True)
    xq = fake_quant_unsigned(hdn, q.features, q.w_qbits)
    Wq = fake_quant_signed(p["W5"], q.weights, q.w_qbits)
    hdn = dist_gnn_layer_halo(mesh, P.HG, xq, Wq, relu=False)
    hdn = ste(hdn, hdn * q.deq_o)
    ls = F.cross_entropy(hdn @ p["Wo"], P.y, reduction="none")
    return torch.sum(ls * P.m) / torch.sum(P.m)


def dryrun_multichip(n_shards: int, *, tb: int = 8, device=None):
    """Build the problem on an in-process mesh of ``n_shards`` shards on
    ``device`` (the CUDA card unless the caller asks for the CPU), take one
    training step from ``init_params`` and return ``(loss, updated
    parameters, gradients)``; raises on a non-finite loss or parameter."""
    P = build_problem(n_shards, tb=tb, device=device)
    params = dist_params_from_jax(init_params(), device=P.mesh.device)
    for w in params.values():
        w.requires_grad_(True)
    opt = torch.optim.Adam(params.values(), lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    loss = loss_fn(P, params)
    loss.backward()
    grads = OrderedDict((k, w.grad.detach().clone()) for k, w in params.items())
    opt.step()
    if not torch.isfinite(loss):
        raise AssertionError("non-finite loss in the distributed dry run")
    for k, w in params.items():
        if not torch.isfinite(w).all():
            raise AssertionError(f"non-finite parameter {k} after the dry run's step")
    return loss.detach(), OrderedDict((k, w.detach()) for k, w in params.items()), grads
