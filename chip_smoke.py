"""Drive the PyTorch port's GCN and GAT serving and training paths (with
and without remat), its native host prepare and reference-format loaders,
its full-integer int8 serving, its fake-quant (QAT) path, its sampled,
multi-label and graph-classification training loops, its distributed
layers (on the in-process mesh), its backend and flash-layout cost model
and its entry twin and examples once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (so the run exits non-zero):

1. device: require CUDA; print the card's name and power limit
   (nvidia-smi), torch and CUDA versions; TF32 off. Then the measured
   entries of utils/roofline.H100_PEAKS (f32 elementwise, exp, copy),
   each beside the table's value (phase_peaks).
2. build: compile the hand-written kernels (sgracex1_tpu_torch/csrc/*.cu)
   with nvcc for sm_90a, one nvcc per source, all started together.
3. kernels against their plain PyTorch versions on the card at small
   sizes: K1 (bsr_spmm) and K2 (bsr_spmm_fused) in the three tile forms,
   rank-1 and value mode, with and without a remainder, ragged n and P,
   f32 and bf16 H, and on transposed plans, each case through the kernel
   its shape selects (the ring kernels for int8 and bf16 tiles of height
   64-256 at P % 8 == 0, else the single-stage ones) and, where both take
   it, through the other as well; K3 and K6 over the tile forms,
   head counts, ragged widths, isolated rows, split runs and chunk layouts,
   likewise through the kernel flash_ring_shape_ok selects and the other;
   K4 and K5 over the same forms and under merged hybrid stats, likewise
   (flash_bwd_ring_shape_ok); small GCN
   and GAT forwards and gradients through the kernels against the f32
   edge path. K7 (bsr_spmm_int8) and K8 (bsr_spmm_int8_fused) must equal
   their plain versions and a scipy integer product (tb 64, 128 and 256, P
   in {8, 16, 32, 100, 128}, a row block without a tile, dead chunk slots,
   split runs, both attach_chunks modes; K7 also at tb 512), each through
   the kernel its shape selects (the int8 ring kernel on the tiles, or row
   pieces, that carry an edge: K7 at any tb % 64 == 0, K8 at tb 64-256,
   both at P % 16 == 0; else the single-stage one) and, where the ring
   kernel took it, the single-stage kernel as well.
4. the GCN slice: 2^20-node power-law graph (avg degree 16, 100 features,
   16 classes, seed 0), sym_norm, degree order, one hybrid prepare with
   the transposed plans at SLICE_SPLIT (tb 256, threshold 64: the shapes
   every slice phase measures; the cost model's own choices are phase
   20's). The host prepare runs on the native library
   (runtime/native, built from csrc/sgrace_host.cpp with g++; the run fails
   if it does not build): sym_norm_edges, rcm_order and plan_spmm at
   1024/1024/1024 each timed beside its numpy spec and identical to it, K9
   on the native plan torch.equal to K9 on the numpy plan; K1 and K2 (the ring kernels) timed against their
   plain versions, with their bound and the library call (torch.sparse.mm
   on the CSR form) beside them, the single-stage kernels in the same run
   through their private entries, on all steps, on the live steps alone
   and reading H staged once in bf16, the ring kernels on the transposed
   plans and over RING_SEG_STEPS 8/16/32/64; a 2-layer width-128 GCNModel
   (random weights from a numpy seed) answers 3 requests through K2 and
   one through K1, then trains for 3 epochs (K2 on the plan and its
   transpose; one step through the K1 view), each held against the
   plain-kernel versions; every launch of these runs must be a ring kernel.
   One step of the same model with remat=True: logits torch.equal to the
   step without remat, gradients torch.equal or within REMAT_TOL, K2 five
   times (the ReLU layer's aggregation recomputed, not the last layer's),
   step ms and peak memory of both.
4a. the reference's input files at pubmed's descriptor (N 19 717, M 500,
   108 365 adjacency and 988 031 feature nonzeros, weights 500 x 128),
   written from a seed into a temporary directory and read by the native
   and the numpy parser (identical) and load_reference_dataset; the
   reference's call ReLU(A (X W)) with X W on the edge path and the
   aggregation through prepare_adjacency (auto: the cost model's kind,
   printed; its kernel once) and agg_matmul, against the all-edge-path
   gnn_layer and spmm_dense_rhs.
5. the GAT slice on the same graph: K6 and K3 (the ring kernel, with the
   single-stage kernel timed in turns beside it) at H=4 and H=1, F=64; K4
   and K5 likewise (the backward ring kernels, K5 on the transposed live
   tiles) on the bf16 operands flash_gat_backward hands them, the f32-in
   call beside them; all with their bounds; GATModel(100, 64, 16, nheads=4)
   answers 3 requests through K6 and trains for 3 epochs (K6, K4, K5);
   every K3-K6 launch of those runs must be the ring kernel. Before it,
   gat_attention_agg (H=1, F=64) on the slice's dense attention part: its
   forward torch.equal to K3, its edge backward's gradients against the f32
   edge path (AGG_REF_TOL) and against K3/K4/K5 (AGG_FUSED_TOL). After it,
   one remat step as in 4 (K6 four times).
6. the small GAT path (n=8192, full-cover tiles): 3 requests and 3
   training epochs through K3, K4 and K5 (the ring kernels).
7. K8 at full width: the slice's graph quantized to 8 bits,
   prepare_int8_hybrid (tb 256, threshold 64, K 128), Hq from a numpy
   seed; int8_hybrid_agg three times on the int8 ring kernel, equal to the
   plain version; the ring and the single-stage K8 timed in turns, with the
   bound on the tiles that carry an edge and on all tiles; K7 (the ring
   kernel) on the plan's dense part timed.
8. fake-quant GCN at 2^20, width 128: calibrate() from one float forward
   with telemetry, the 8-bit GCNModel on a value-tile prep (the hybrid
   split at SLICE_SPLIT without rank-1 masks), forwards held against the
   plain-K1 forward, the adjacency quantizer's cost for what a forward
   reads and for every representation, then 3 training epochs (the ring K1
   on bsr and bsr_t).
9. int8 GCN serving (freeze_gcn2_sparse -> int8_gcn2_sparse_forward, 100
   -> 128 -> 16) at n=2^16 on a full int8 tile cover: 3 requests, K7 twice
   each on the ring kernel, equal to the plain-K7 forward, on the slice's
   power-law generator at tb 256 and at freeze_gcn2_sparse's default tb 512
   (K7 timed at its shapes, the ring kernel beside the single-stage one,
   the bound on the row pieces that carry an edge; the error against the
   float forward is printed) and on a bounded-degree banded graph, where
   the output must lie within 0.08 of the float forward.
10. one int8 GAT layer on K3 at n=8192 against the plain K3 and, on the
   rows whose degree the 255 grid resolves, the edge-list int8 layer.

11. K9-K12 against their plain versions at small sizes: K9
   (spmm_plan) over rb/cb 128, 256 and 1024, be 1024 and 2048, P in {16, 33,
   100, 128}, f32 and bf16 H, ragged n, a row block without a group, the
   empty matrix, H with spare rows, weighted and rank-1 values, a split hub
   row, plan_with_vals and plan_t, through the kernel its shape selects (the
   gather kernel at P % 8 == 0, else the first kernel) and, where the gather
   kernel took it, the first kernel too; K10 (bsr_spmm_rowloop) in the tile forms
   with an empty row block, also against K1, through the kernel its shape
   selects (the cluster kernel for int8 and bf16 tiles of height 64-256 at
   P % 8 == 0, else the single-stage one) and, where the cluster kernel took
   it, the single-stage one too; the cluster kernel at clusters of 8 and 16
   on a hub row block of hundreds of live tiles and on an all-light band;
   K11 (bsr_spmm_fused_k) at k 2 and 4 in both attach_chunks modes, with and
   without scalings, at P 100 (single-stage) and 128 (the ring kernel where
   fused_k_ring_shape_ok holds, equal to K2's ring at k = 2), also against
   K2 on the unpadded plan; K12 (flash_gat_forward_subskip) on int8
   and value tiles with isolated rows at sb 8 to 256, through the kernel its
   shape selects (the flash ring kernel at F = 64, else the single-stage
   one) and the single-stage kernel too, equal to K3 on the same route, and
   on a bitmap that clears populated sub-blocks against the plain K12.
12. the pallas kind at full width on the GCN slice's graph:
   prepare_from_config with SGRACEConfig(use_pallas=True, row_block=1024,
   col_block=1024, edge_block=1024); the seconds and bytes plan_t adds to a
   prep made with build_transpose=False; K9 timed at P = 128 against its plain
   version, its bound and torch.sparse.mm, the gather and the first kernel
   in turns, on plan and plan_t, and the gather kernel over ROW_SEG_SLOTS
   16-256; the width-128 GCNModel answers 3 requests through K9 (logits
   against the plain-K9 forward and the K2 forward) and trains for 3 epochs
   (K9 on plan and plan_t); one agg_matmul_with_vals forward and backward
   with random positive values; every K9 launch of these runs must be the
   gather kernel; K9 alone at the config's default tiling (128 / 128 /
   2048). Then the plan attention at the gat-products cell's shapes
   (phase_plan_gat_products): its graph (2^20 nodes, mean degree 50.5),
   sym_norm and its prepare with gat_self_loops (no mask tile); the
   forward, the backward's row pass and its column pass at 4 heads of 128
   and of 47 against their plain versions (2e-5 of the largest magnitude),
   timed beside the gat family's bound; the layer's entry forward and
   backward with its launch counters set to 0 just before it.
13. the variants at the slice's shapes, each through its own entry point:
   K10 (the cluster kernel; the hub row block's split, the clusters the card
   holds) on the slice's tiles and on a banded graph beside the single-stage
   K10, K1's ring and torch.sparse.mm, at clusters of 8 and 16; K11 (the ring
   kernel) on the slice's split at k 2 and 4 beside the single-stage K11 and
   K2's ring, bit-equal to K2's ring where it walks the same schedule at
   k = 2; K12 at H = 1, F = 64 on the slice's attention tiles and at n=8192
   at sb 8 to 256 (the ring kernel beside the single-stage one), equal to
   the ring K3 on the same tiles, beside the ring and the single-stage K3
   (the plain K12 at sb >= 64 on the slice, at every sb at n=8192).

14. the neighbor-sampled loop on the GCN slice's graph
   (train_node_classifier_sampled, GCNModel(100, 128, 16), 4096 train seeds
   from default_rng(0), batches of 1024, fanouts (10, 10), 2 epochs,
   prepare="auto"): each batch's kind as the cost model picks it (printed
   with the model's prices and host seconds), four launches a step of its
   kernel (K2, or K9 for pallas); each batch's n_pad, e_pad, tiles and
   chunks, host seconds of sampling and prepare, step and epoch ms, peak
   memory.
15. PPI-shaped inductive multi-label training (train_multilabel_inductive,
   24 graphs of 2373 nodes, 50 features, 121 labels, 20/2/2;
   GATModel(50, 64, 121, nheads=4, dropout=0), lr 0.005, 2 epochs,
   prepare="auto"): full-cover flash tiles, K3 x2, K4 x2, K5 x2 a step on
   the ring kernels; micro-F1 by epoch.
16. MUTAG-shaped graph classification (train_graph_classifier,
   MoleculeGCN(7, 64, 2), 150 molecules, 120/30, batches of 32 at
   pad_to=64, 36 epochs, prepare="bsr"): K2 on block-diagonal batches,
   four times a step; the best test accuracy beside the 0.76 anchor; then
   calibrate() on the trained model and one batch on the card and
   MOL_QAT_EPOCHS 8-bit fake-quant epochs from that table (value tiles, K1
   four times a step).
   Each of 14-16 holds one step of its loop (logits and every gradient)
   against the same step on the plain kernels.
17. the distributed GCN training step (BASELINE.json config 5,
   benchmarks/bench_dist_train.main_large cut to 2^20 nodes on 4 shards of
   the in-process mesh) on 14's products-density graph: sym_norm,
   degree_balanced_order, the global rank1_factor, build_halo,
   build_halo_fused (host seconds of each); dist_gnn_layer_halo_fused
   100 -> 128 -> 128 and a head, masked cross-entropy, Adam; K2 16 times a
   step on the ring kernel; per-shard plan bytes and local-edge share,
   halo bytes (halo_comm), step ms, the in-process exchange's ms, a
   profiler window, peak memory; one step against the plain kernels and
   the kernel-free dist_gnn_layer_halo.
18. the halo GAT at full width on 5's graph: dist_gat_layer_halo_flash
   (4 heads of 64) on each shard's full-cover int8 mask tiles, K3, K4, K5
   once a shard a pass on the ring kernels, against the plain kernels and
   the edge-path dist_gat_layer_halo; dist_gnn_layer_halo_bsr on bf16
   value tiles (K1 on the ring kernel, forward and transposed) against
   dist_gnn_layer_halo.
19. the twin of the JAX package's dryrun_multichip(4) at tb 32 (the
   single-stage K1-K5): every distributed layer kind, one Adam step, against
   the plain-kernel step.

20. the cost model (PR 15): every device-timed entry of
   ops/dispatch.H100_COSTS re-measured on synthetic layouts (K2's tile at
   each candidate size and form, its chunk and slot, the step; K9's group
   and edge; the edge path; the dense kind; the pre-pass rows; the flash
   tile, run, chunk and backward ratio at H=4 and H=1; the remainder's
   edge backward) and printed beside the table, failing where a held
   entry is off by more than 2x; then, on the GCN slice, the
   reference-format pubmed graph, one PPI graph and one molecule batch,
   every kind auto prices, predicted beside measured agg_matmul ms (P =
   128) and the prep's GiB, auto's choice within 1.15x of the fastest.
   Around the GCN slice's training epochs a PowerRecorder on nvidia-smi's
   power.draw: mean W and J an epoch.
21. the flash layouts for_gat picks on the GAT slice for training and for
   serving, against the split at SLICE_SPLIT and full cover where it fits
   the budget: predicted beside measured (H=4, F=64), each choice within
   1.15x of the fastest.
22. the entry twin (graft_entry.entry) against the CPU edge path, and the
   examples quantization_pipeline, ppi_gat and distributed_training on the
   card, with their launch counts.
23. the last ported JAX functions: bsr_spmm_xla, pack_mask_bsr and the
   sharded train-state pair, one call each (phase_fill_ins); the fused
   plan's chunk-width chooser on the GCN slice, K2 at K 128 / 256 / 512
   against the plain K2, the chosen K within 1.15x of the fastest
   (phase_k_chooser); the flash kernels' ablation options on the GAT slice
   at H=4 and H=1, K3/K4/K5 exact and with fast_exp, K6 at chunk modes
   full / noscore / off, each against its plain version at the same option
   and timed in turns (phase_flash_variants, small cases in
   _flash_variants_small); the sticky padding of the sampled loop at
   prepare="hybrid" and of the molecule loop at prepare="bsr": padded preps
   keep the unpadded live schedules and their steps match the unpadded
   steps (phase_padding).

Every main path is driven with the launch counts set to 0 just before it
and read just after. The last two lines are the kernels' JSON record
(name, route, source, the TPU kernel replaced, launches, error, kernel /
plain / bound / library milliseconds) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from sgracex1_tpu_torch import (
    GATModel, GCNModel, MoleculeGCN, SGRACEConfig, agg_matmul, prepare_adjacency, prepare_from_config,
    sym_norm, train_graph_classifier, train_multilabel_inductive, train_node_classifier,
    train_node_classifier_sampled,
)
from sgracex1_tpu_torch.graph import io as GIO
from sgracex1_tpu_torch.graph.batch import make_batches
from sgracex1_tpu_torch.graph.csr import SparseMatrix
from sgracex1_tpu_torch.graph.datasets import (
    NodeClassificationData, powerlaw_node_classification, products_density_graph, synthetic_molecules,
    synthetic_ppi,
)
from sgracex1_tpu_torch.graph.normalize import rank1_factor, sym_norm_edges
from sgracex1_tpu_torch.graph.reorder import (
    bandwidth, degree_balanced_order, degree_order, permute_graph, rcm_order, shard_edge_counts,
)
from sgracex1_tpu_torch.runtime import native
from sgracex1_tpu_torch.nn.convert import dist_params_from_jax
from sgracex1_tpu_torch.ops import _cuda
from sgracex1_tpu_torch.ops import bsr as K1
from sgracex1_tpu_torch.ops import fused_agg as K2
from sgracex1_tpu_torch.ops import flash_gat as FG
from sgracex1_tpu_torch.ops import pallas_spmm as K9
from sgracex1_tpu_torch.ops import plan_gat as PG
from sgracex1_tpu_torch.ops.fused_gnn import gnn_layer, relu_hw
from sgracex1_tpu_torch.ops.spmm import spmm, spmm_dense_rhs
from sgracex1_tpu_torch.parallel import dryrun as DR
from sgracex1_tpu_torch.parallel import halo as HALO
from sgracex1_tpu_torch.parallel import halo_fused as HF
from sgracex1_tpu_torch.parallel.comm_model import allgather_comm, halo_comm
from sgracex1_tpu_torch.parallel.mesh import make_mesh
from sgracex1_tpu_torch.parallel.partition import pad_nodes
from sgracex1_tpu_torch.ops import dispatch as D
from sgracex1_tpu_torch.ops.dispatch import _drop_zero_val_edges, agg_matmul_with_vals, split_by_tile_density
from sgracex1_tpu_torch.quant import int8 as Q
from sgracex1_tpu_torch.quant.affine import QuantConstants, fake_quant_unsigned, generate_constants
from sgracex1_tpu_torch.quant.autocal import calibrate
from sgracex1_tpu_torch.quant.calibration import CalibrationTable
from sgracex1_tpu_torch.train import loop as TL
from sgracex1_tpu_torch.train.loop import _masked_xent
from sgracex1_tpu_torch import graft_entry
from sgracex1_tpu_torch.examples import distributed_training as EX_DIST
from sgracex1_tpu_torch.examples import ppi_gat as EX_PPI
from sgracex1_tpu_torch.examples import quantization_pipeline as EX_QP
from sgracex1_tpu_torch.utils import roofline as RL
from sgracex1_tpu_torch.utils.power import PowerRecorder, gpu_power_limit_w, gpu_power_w
from sgracex1_tpu_torch.utils.profiling import cuda_ms

SLICE = dict(n=1 << 20, avg_degree=16, num_features=100, num_classes=16, seed=0)
HIDDEN = 128
REQUESTS = 3
K2_TOL = 2e-2  # both write bf16
K1_TOL = 1e-3  # identical bf16 operands, f32 sums in another order
GAT_TOL = 2e-2  # bf16(p) rounds against each CTA segment's running max
GAT_HIDDEN, GAT_HEADS = 64, 4  # examples/ppi_gat.py: 4 heads x 64, then 1 x 64
GAT_SMALL = dict(SLICE, n=8192)
TRAIN_EPOCHS = 3
# one step's gradients against the plain-kernel step, relative to each
# gradient's largest entry: the same bf16 operands, but p rounds to bf16
# against each segment's running max and through the fast exp
GRAD_TOL = 2e-2
KERNELS = (K1.bsr_spmm, K2.bsr_spmm_fused, FG.flash_gat_forward, FG.flash_gat_bwd_row,
           FG.flash_gat_bwd_col, FG.flash_gat_hybrid_forward, K1.bsr_spmm_int8,
           K2.bsr_spmm_int8_fused, K9.spmm_plan, K1.bsr_spmm_rowloop, K2.bsr_spmm_fused_k,
           FG.flash_gat_forward_subskip)
K9_TOL = 1e-3  # identical roundings, f32 sums in another order (as K1)
PALLAS_LOGIT_TOL = 2e-2  # two K9 layers: the second rounds the first's sums to bf16
# the plan attention against its plain version, of the largest magnitude (the
# card tests' tolerance: the same bf16 rows, f32 sums in another order, __expf)
PLAN_GAT_TOL = 2e-5
PLAN_GAT_SEED = 21  # the gat-products graph's seed in phase_plan_gat_products
# the pallas kind at the tiling prepare_adjacency defaults to
PALLAS_CFG = dict(use_pallas=True, row_block=1024, col_block=1024, edge_block=1024)
INT8_GCN = dict(SLICE, n=1 << 16)  # full int8 tile cover: at most 256^2 tiles of 64 KiB
INT8_TB = 256
INT8_REL_TOL = 0.08  # int8 2-layer GCN against the float forward, of its largest output
INT8_GAT_TOL = 0.03  # int8 GAT on K3 against the edge-list int8 GAT, of its largest output
INT8_GAT_MAX_DEGREE = 32  # rows whose attention weights the edge-list layer's 255 grid resolves
QAT_TOL = 2e-2  # fake-quant logits against the plain-K1 forward, of the largest logit
# the sampled loop: ogbn-products' density class (products_density_graph,
# ~29 edges a node) cut from 2.45 M nodes to 2^20, and its GraphSAGE batch
# of 1024 seeds, 4 batches an epoch; such a batch reaches tens of thousands
# of nodes, past the dense limit, so prepare="auto" makes it hybrid
SAMPLED_GRAPH = dict(n=1 << 20, tail_degree=16, ring=12, num_features=100, num_classes=16, seed=0)
SAMPLED_SEEDS, SAMPLED_BATCH, SAMPLED_EPOCHS = 4096, 1024, 2
# PPI's shape: 24 graphs of ~2373 nodes (56 944 in all), 20/2/2, 50 features, 121 labels
PPI = dict(num_graphs=24, n_per=2373, num_features=50, num_labels=121, splits=(2, 2), seed=0)
PPI_EPOCHS = 2
PPI_LOSS_TOL = 0.01  # the last epoch's mean loss over the labels' entropy, less 1
MOL_HIDDEN, MOL_EPOCHS = 64, 36  # the MUTAG notebook's width and its anchor's epoch
MOL_QAT_EPOCHS = 5  # 8-bit fake-quant epochs from the calibrated table
# the distributed path (BASELINE.json config 5, bench_dist_train.main_large
# cut from 2^22 nodes on 8 devices to 2^20 on 4 shards of one card)
DIST_SHARDS = 4
DIST_STEPS = 3
DIST_GAT_HEADS, DIST_GAT_F = 4, 64  # all heads in one flash launch; the flash ring's F
# the CUDA tile kernels take tb % 32 == 0; the JAX dry run's tb = 8 runs on the CPU only
DIST_DRYRUN_TB = 32
# the reference-format files: pubmed's descriptor (graph/io.REFERENCE_DATASETS)
# and a weights file of this width
REF_DATASET, REF_HIDDEN = "pubmed", 128
REF_TOL = 2e-2  # K2 rounds H, the tile values and its output to bf16: of the largest output
# gat_attention_agg: its edge backward against autograd through the f32 edge
# path (the same function, sums in another order), and against K4/K5, which
# round p, q, gO and Wh to bf16; both of the largest gradient entry
AGG_REF_TOL, AGG_FUSED_TOL = 1e-4, 5e-2
# a remat step's gradients against the step without remat where they are
# not bit-identical (float atomics in a scatter), of the largest entry
REMAT_TOL = 1e-5
# the hybrid split every slice phase measures (PERF.md §6's shapes): the
# aggregation prep, the GAT layout, the int8 plan, the fake-quant prep and
# the banded graph; the cost model's own choices are phase_cost_model's
SLICE_SPLIT = (256, 64)
EXAMPLE_TOL = 2e-2  # the entry twin's logits on the card against the CPU edge path, of the largest
EXAMPLE_EPOCHS = 20  # quantization_pipeline's float and QAT epochs on the card
POWER_INTERVAL_S = 0.02  # the power recorder's sampling interval (each sample runs nvidia-smi)


def _log(msg: str) -> None:
    print(msg, flush=True)


def _check(name: str, out, ref, tol: float) -> float:
    """Hold ``out`` against ``ref`` at rtol = atol = tol; max abs error."""
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: shape {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite")
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol, msg=lambda m: f"{name}: {m}")
    return float((out.float() - ref.float()).abs().max())


def _agg_bound(B, H, out, kind, plan=None, ring=None) -> dict:
    """Bound of one aggregation (K1, K2, K8, K10, K11) on this run's live
    tiles and chunks (``utils/roofline.cost_tiles``)."""
    return RL.cost_tiles(B, H.shape[1], RL.nbytes(H, out), plan=plan, ring=ring, op=kind).bound()


def _flash_bound(B, tensors, H, F, products, plan=None) -> dict:
    """Bound of a flash-GAT pass on this run's live tiles and chunks
    (``utils/roofline.cost_flash_gat``)."""
    return RL.cost_flash_gat(B, H, F, RL.nbytes(*tensors), products=products, plan=plan).bound()


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    _log(_card())
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log("allow_tf32: matmul=False cudnn=False")


def phase_build():
    t0 = time.perf_counter()
    _cuda.library()
    _log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_seconds:.1f} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            _log("  " + line.strip())
    # the ring kernels by name: tile mode 2 int8 / 0 bf16, fused (K2, K11)
    # or not (K1), slabs a stage (1; K11: 2 or 4) and their depth
    ring = re.findall(r"Function properties for \S*agg_ring_kernelILi(\d)ELb(\d)E\S*?Li(\d)ELi(\d+)EE"
                      r"\S*\n\s*(.*)\n.*Used (\d+) registers", _cuda.build_log)
    for mode, fused, slabs, sd, spills, regs in ring:
        name = ("K11" if slabs != "1" else "K2") if fused == "1" else "K1"
        _log(f"  ring kernel {name} {'int8' if mode == '2' else 'bf16'} tiles, {slabs} slab(s) a stage, {sd} deep: "
             f"{regs} registers at entry (consumers raise to 232, the producer drops to 40), {spills.strip()}")
    if _cuda.build_log and len(ring) != 7:  # no log when the library was built by an earlier run
        raise AssertionError(f"expected the seven ring kernels (K1, K2, K11) in the build log, found {len(ring)}")
    # the flash ring kernels by tile mode and head count: K3/K6, and K12's own (H=1, the bitmap); and
    # the variants of K3/K6 (VAR 1 fast_exp, 2 K6's noscore chunks), each from a source of its own
    flash = re.findall(r"Function properties for \S*flash_ring_kernelILi(\d)ELi(\d)ELb(\d)ELi(\d)E\S*\n\s*(.*)\n"
                       r".*Used (\d+) registers", _cuda.build_log)
    variant = {"0": "", "1": ", fast_exp variant", "2": ", noscore variant"}
    for mode, heads, sub, var, spills, regs in flash:
        _log(f"  flash ring kernel ({'K12' if sub == '1' else 'K3/K6'}{variant[var]}) "
             f"{'int8' if mode == '2' else 'bf16'} tiles, H={heads}: {regs} registers at entry (consumers raise to "
             f"232, the producer drops to 40), {spills.strip()}")
    if _cuda.build_log and sorted(Counter(v for *_, v, _, _ in flash).items()) != [("0", 8), ("1", 6), ("2", 6)]:
        raise AssertionError(f"expected the eight flash ring kernels (six K3/K6, two K12) and six of each variant "
                             f"in the build log, found {len(flash)}")
    # the backward ring kernels (K4 / K5) by tile mode and head count, and their fast_exp variants
    bwd = re.findall(r"Function properties for \S*bwd_ring_kernelILi(\d)ELi(\d)ELb(\d)ELb(\d)E\S*\n\s*(.*)\n"
                     r".*Used (\d+) registers", _cuda.build_log)
    for mode, heads, col, fast, spills, regs in bwd:
        _log(f"  backward ring kernel ({'K5' if col == '1' else 'K4'}{', fast_exp variant' if fast == '1' else ''}) "
             f"{'int8' if mode == '2' else 'bf16'} tiles, H={heads}: {regs} registers at entry (consumers raise to "
             f"232, the producer drops to 40), {spills.strip()}")
    if _cuda.build_log and sorted(Counter(f for *_, f, _, _ in bwd).items()) != [("0", 12), ("1", 12)]:
        raise AssertionError(f"expected the twelve backward ring kernels and their twelve fast_exp variants in the "
                             f"build log, found {len(bwd)}")
    # the cluster K10 by tile mode and cluster size
    clus = re.findall(r"Function properties for \S*rowloop_cluster_kernelILi(\d)ELi(\d+)E\S*\n\s*(.*)\n.*Used (\d+) registers",
                      _cuda.build_log)
    for mode, C, spills, regs in clus:
        _log(f"  cluster K10 {'int8' if mode == '2' else 'bf16'} tiles, C={C}: {regs} registers at entry, {spills.strip()}")
    if _cuda.build_log and len(clus) != 4:
        raise AssertionError(f"expected the four cluster K10 kernels in the build log, found {len(clus)}")
    # the gather K9 by lanes a worker, and the int8 ring K8
    gather = re.findall(r"Function properties for \S*plan_gather_kernelILi(\d+)E\S*\n\s*(.*)\n.*Used (\d+) registers",
                        _cuda.build_log)
    for lanes, spills, regs in gather:
        _log(f"  gather K9, {lanes} lane(s) a worker: {regs} registers, {spills.strip()}")
    if _cuda.build_log and len(gather) != 6:
        raise AssertionError(f"expected the six gather K9 kernels in the build log, found {len(gather)}")
    i8 = re.findall(r"Function properties for \S*agg_ring_i8_kernel\S*\n\s*(.*)\n.*Used (\d+) registers",
                    _cuda.build_log)
    for spills, regs in i8:
        _log(f"  int8 ring K7/K8: {regs} registers at entry (consumers raise to 232, the producer drops to 40), "
             f"{spills.strip()}")
    if _cuda.build_log and len(i8) != 1:
        raise AssertionError(f"expected the int8 ring K7/K8 kernel in the build log, found {len(i8)}")


def _random_graph(n, weighted, seed, isolated=None):
    """Random edges plus dense hub rows/cols: tiles past the threshold and
    a sparse remainder. With ``isolated``, nodes i % isolated == 3 get no
    edge (sym_norm leaves them only a zero-valued self-loop)."""
    rng = np.random.default_rng(seed)
    h = np.stack([rng.integers(0, 200, 20 * n), rng.integers(0, n, 20 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 4 * n)), h, h[::-1]], axis=1), axis=1)
    if isolated:
        ei = ei[:, (ei % isolated != 3).all(axis=0)]
    if not weighted:
        return sym_norm(ei, n)
    v = rng.uniform(0.5, 2.0, ei.shape[1]).astype(np.float32)
    return SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))


def phase_kernels_small(device):
    """K1 and K2 against their plain versions over the forms and modes."""
    cases = [
        # name, n, P, weighted, method, tb, rest_thresh, H dtype
        ("int8-rank1-hybrid-ragged", 3001, 100, False, "hybrid", 128, 24, torch.float32),
        ("int8-rank1-hybrid-bf16H", 3001, 128, False, "hybrid", 256, 100, torch.bfloat16),
        ("packed-rank1-hybrid", 20000, 72, False, "hybrid", 1024, 250, torch.float32),
        ("bf16-values-hybrid", 2500, 128, True, "hybrid", 128, 24, torch.float32),
        ("int8-rank1-bsr", 4100, 40, False, "bsr", 128, None, torch.float32),
        ("bf16-values-bsr-P200", 2100, 200, True, "bsr", 256, None, torch.float32),
        ("int8-rank1-hybrid-tb64-P8", 1500, 8, False, "hybrid", 64, 8, torch.float32),
        ("bf16-values-hybrid-tb192-P64-bf16H", 2000, 64, True, "hybrid", 192, 40, torch.bfloat16),
        ("int8-rank1-hybrid-tb256-P264", 3001, 264, False, "hybrid", 256, 100, torch.float32),
    ]
    gen = torch.Generator(device=device).manual_seed(0)
    took = {True: 0, False: 0}
    for i, (name, n, P, weighted, method, tb, thr, hdt) in enumerate(cases):
        A = _random_graph(n, weighted, seed=i)
        prep = prepare_adjacency(
            A, method=method, tb=tb, rest_thresh=thr, build_transpose=False,
            device=device,
        )
        H = torch.randn(n, P, generator=gen, device=device).to(hdt)
        ref2, ref1 = K2.bsr_spmm_fused_plain(prep.fused, H), K1.bsr_spmm_plain(prep.bsr, H)
        _reset_counts()
        e2 = _check(f"K2 {name}", K2.bsr_spmm_fused(prep.fused, H), ref2, K2_TOL)
        e1 = _check(f"K1 {name}", K1.bsr_spmm(prep.bsr, H), ref1, K1_TOL)
        # the kernel is chosen by tile form and shape alone
        ring = prep.bsr.tiles.dtype in (torch.int8, torch.bfloat16) and tb % 64 == 0 and tb <= 256 and P % 8 == 0
        if ring != K1.ring_shape_ok(K1._tile_mode(prep.bsr.tiles, tb), tb, P, prep.fused.K):
            raise AssertionError(f"{name}: ring_shape_ok disagrees with the rule")
        for k in (K1.bsr_spmm, K2.bsr_spmm_fused):
            if (k.launches_ring, k.launches_single) != (int(ring), int(not ring)):
                raise AssertionError(f"{name}: {k.__name__} took the wrong kernel for its shape")
        took[ring] += 1
        if ring:  # the single-stage kernels take every shape: hold them too
            _check(f"K2 single-stage {name}", K2._bsr_spmm_fused_single(prep.fused, H), ref2, K2_TOL)
            _check(f"K1 single-stage {name}", K1._bsr_spmm_single(prep.bsr, H), ref1, K1_TOL)
        rest = prep.rest.nnz if prep.rest is not None else 0
        L = prep.fused.ring
        _log(f"  {name} [{'ring' if ring else 'single-stage'} kernels]: T={prep.bsr.num_tiles} "
             f"(live {int(prep.bsr.live.sum())}) tiles {tuple(prep.bsr.tiles.shape[1:])} "
             f"{prep.bsr.tiles.dtype} rest={rest} chunks={prep.fused.num_rest_chunks} "
             f"steps={prep.fused.num_steps} live steps={L.step.shape[0]} "
             f"ring segments={L.segments.n_seg} split_runs={L.segments.n_fin} "
             f"K2 err {e2:.3g} K1 err {e1:.3g}")
    if not (took[True] and took[False]):
        raise AssertionError("the small cases must reach both the ring and the single-stage kernels")

    # f32 value tiles and non-attached chunk steps (kind 1), built directly
    A = _random_graph(2600, True, seed=9)
    part, rest = split_by_tile_density(A, 256, 24)
    B = K1.bsr_from_sparse(part, tb=256, dtype=torch.float32, cover_rows=True,
                           cover_cols=True, device=device)
    plan = K2.build_fused_plan(B, rest, attach_chunks=False)
    assert (plan.step_kind == 1).any()
    H = torch.randn(2600, 64, generator=gen, device=device)
    e2 = _check("K2 f32-values-unattached", K2.bsr_spmm_fused(plan, H),
                K2.bsr_spmm_fused_plain(plan, H), K2_TOL)
    e1 = _check("K1 f32-values", K1.bsr_spmm(B, H), K1.bsr_spmm_plain(B, H), K1_TOL)
    _log(f"  f32-values-unattached: K2 err {e2:.3g} K1 err {e1:.3g}")

    # a small GCN forward through K2 against the f32 edge path
    A = _random_graph(3001, False, seed=11)
    net = GCNModel(32, 64, 7, generator=torch.Generator().manual_seed(0)).to(device).eval()
    x = torch.randn(3001, 32, generator=gen, device=device)
    with torch.no_grad():
        out = net(prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=24,
                                    build_transpose=False, device=device), x)
        ref = net(prepare_adjacency(A, method="xla", device=device), x)
    e = _check("small GCN K2 vs edge path", out, ref, 5e-2)
    _log(f"  small GCN (3001 nodes) K2 route vs f32 edge path: max err {e:.3g}")
    _gat_kernels_small(device, gen)
    _bwd_kernels_small(device, gen)
    _flash_variants_small(device, gen)


def _scores(n, H, F, gen, device):
    s1 = torch.randn(n, H, generator=gen, device=device) * 2
    s2 = torch.randn(n, H, generator=gen, device=device) * 2
    return s1, s2, torch.randn(n, H, F, generator=gen, device=device)


def _check_flash(name, res, ref) -> float:
    """(out, m, l) of a kernel against its plain version: out and l at
    GAT_TOL, m exactly (the same f32 operations)."""
    err = _check(name, res[0], ref[0], GAT_TOL)
    _check(name + " m", res[1], ref[1], 0.0)
    _check(name + " l", res[2], ref[2], GAT_TOL)
    return err


def _flash_ring_rule(B, H, F, K=None) -> bool:
    """The ring kernel's shape rule, written out here, held against
    ``FG.flash_ring_shape_ok``."""
    rule = (B.tiles.dtype in (torch.int8, torch.bfloat16) and B.tiles.shape[-1] == B.tb
            and B.tb % 64 == 0 and B.tb <= 256 and F == 64 and H in (1, 2, 4) and (K is None or K % 64 == 0))
    if rule != FG.flash_ring_shape_ok(K1._tile_mode(B.tiles, B.tb), B.tb, H, F, K):
        raise AssertionError("flash_ring_shape_ok disagrees with the rule")
    return rule


def _flash_route(kern, ring: bool, name: str, fn):
    """``fn()``, checking that ``kern`` launched the kernel its shape
    selects (the ring kernel or the single-stage one) exactly once."""
    before = (kern.launches_ring, kern.launches_single)
    res = fn()
    if (kern.launches_ring - before[0], kern.launches_single - before[1]) != (int(ring), int(not ring)):
        raise AssertionError(f"{name}: {kern.__name__} took the wrong kernel for its shape")
    return res


def _gat_kernels_small(device, gen):
    """K3 and K6 against their plain versions; a small GATModel through
    both against the edge path."""
    k3_cases = [
        # name, n, prepare keywords, H, F, stats
        ("int8-tb128-hub-H4-F64", 3001, dict(method="xla", gat_tb=128), 4, 64, True),
        ("int8-tb256-H1-F40", 3001, dict(method="xla"), 1, 40, False),
        ("packed-tb1024-H4-F16", 5000, dict(method="xla", gat_tb=1024), 4, 16, True),
        ("bf16-values-bsr-H4-F64-ragged", 2100, dict(method="bsr", rank1=False, tb=256), 4, 64, True),
        ("int8-tb256-H4-F8", 4099, dict(method="xla"), 4, 8, True),
        ("int8-tb128-H2-F100-two-feature-slices", 3001, dict(method="xla", gat_tb=128), 2, 100, True),
        ("int8-tb256-H3-F20-unaligned-rows", 3001, dict(method="xla"), 3, 20, False),
        ("int8-tb256-H1-F64", 3001, dict(method="xla"), 1, 64, True),
        ("int8-tb64-H2-F64", 3001, dict(method="xla", gat_tb=64), 2, 64, True),
        ("int8-tb192-H4-F64-ragged", 2900, dict(method="xla", gat_tb=192), 4, 64, False),
        ("bf16-values-bsr-tb128-H1-F64", 2100, dict(method="bsr", rank1=False, tb=128), 1, 64, True),
    ]
    took = {True: 0, False: 0}
    for i, (name, n, kw, H, F, stats) in enumerate(k3_cases):
        A = _random_graph(n, "values" in name, seed=20 + i, isolated=7)
        prep = prepare_adjacency(A, for_gat=True, build_transpose=False, device=device, **kw)
        B = prep.flash_tiles
        s1, s2, Wh = _scores(n, H, F, gen, device)
        ring = _flash_ring_rule(B, H, F)
        res = _flash_route(FG.flash_gat_forward, ring, f"K3 {name}",
                           lambda: FG.flash_gat_forward(B, s1, s2, Wh, return_stats=stats))
        ref = FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=stats)
        took[ring] += 1
        check = (lambda nm, r: _check_flash(nm, r, ref)) if stats else (lambda nm, r: _check(nm, r, ref, GAT_TOL))
        err = check(f"K3 {name}", res)
        out = res[0] if stats else res
        if ring:  # the single-stage kernel takes every shape: hold it too
            check(f"K3 single-stage {name}", FG._flash_gat_forward_single(B, s1, s2, Wh, return_stats=stats))
        has = torch.zeros(n, dtype=torch.bool, device=device)
        has[prep.A.rows[: A.nnz][prep.A.vals[: A.nnz] > 0].long()] = True
        if has.all() or (out[~has] != 0).any():
            raise AssertionError(f"K3 {name}: rows without an edge must come out exactly 0")
        L = B.ring
        _log(f"  K3 {name} [{'ring' if ring else 'single-stage'} kernel]: T={B.num_tiles} (live "
             f"{int(B.live.sum())}) tiles {tuple(B.tiles.shape[1:])} {B.tiles.dtype} "
             f"segments={B.segments.n_seg} split_runs={B.segments.n_fin} ring work items={L.segments.n_seg} "
             f"ring split_runs={L.segments.n_fin} isolated_rows={int((~has).sum())} err {err:.3g}")
        if name.startswith("int8-tb128") and B.segments.n_fin == 0:
            raise AssertionError("the hub case must split a run (merge pass)")

    for tb, thresh in ((128, 40), (256, 100)):
        A = _random_graph(3001, False, seed=30)
        part, rest = split_by_tile_density(A, tb, thresh)
        rest = _drop_zero_val_edges(rest)
        B = K1.bsr_mask_from_sparse(part, tb=tb, cover_rows=True, cover_cols=True, device=device)
        cases = ((True, 4, 64, True), (False, 4, 64, False), (True, 1, 64, True), (True, 2, 40, True)) \
            if tb == 128 else ((True, 2, 64, True), (False, 4, 64, True))
        for attach, H, F, stats in cases:
            plan = K2.build_fused_plan(B, rest, attach_chunks=attach)
            s1, s2, Wh = _scores(3001, H, F, gen, device)
            name = f"K6 tb{tb} {'attached' if attach else 'unattached'}-H{H}-F{F}"
            ring = _flash_ring_rule(B, H, F, plan.K)
            res = _flash_route(FG.flash_gat_hybrid_forward, ring, name,
                               lambda: FG.flash_gat_hybrid_forward(plan, s1, s2, Wh, return_stats=stats))
            ref = FG.flash_gat_hybrid_forward_plain(plan, s1, s2, Wh, return_stats=stats)
            took[ring] += 1
            check = (lambda nm, r: _check_flash(nm, r, ref)) if stats else (lambda nm, r: _check(nm, r, ref, GAT_TOL))
            err = check(name, res)
            if ring:
                check(f"{name} single-stage",
                      FG._flash_gat_hybrid_forward_single(plan, s1, s2, Wh, return_stats=stats))
            kinds = sorted(set(plan.step_kind.tolist()))
            _log(f"  {name} [{'ring' if ring else 'single-stage'} kernel]: T={B.num_tiles} "
                 f"chunks={plan.num_rest_chunks} kinds={kinds} segments={plan.segments.n_seg} "
                 f"split_runs={plan.segments.n_fin} live steps={plan.ring.step.shape[0]} "
                 f"ring split_runs={plan.ring.segments.n_fin} err {err:.3g}")
    if not (took[True] and took[False]):
        raise AssertionError("the small K3/K6 cases must reach both the ring and the single-stage kernels")

    A = _random_graph(3001, False, seed=31, isolated=11)
    net = GATModel(32, 16, 7, nheads=4, generator=torch.Generator().manual_seed(0)).to(device).eval()
    x = torch.randn(3001, 32, generator=gen, device=device)
    with torch.no_grad():
        ref = net(prepare_adjacency(A, method="xla", device=device), x)
        for kw, kern in ((dict(), FG.flash_gat_forward),
                         (dict(gat_tb=128, gat_rest_thresh=40), FG.flash_gat_hybrid_forward)):
            before = kern.launches
            out = net(prepare_adjacency(A, method="xla", for_gat=True, device=device, **kw), x)
            if kern.launches != before + 2:
                raise AssertionError(f"small GAT: {kern.__name__} launched {kern.launches - before} times")
            e = _check(f"small GAT {kern.__name__} vs edge path", out, ref, 5e-2)
            _log(f"  small GAT (3001 nodes) {kern.__name__} route vs f32 edge path: max err {e:.3g}")


def _bwd_ring_rule(B, H, F) -> bool:
    """The backward ring kernels' shape rule, written out here, held
    against ``FG.flash_bwd_ring_shape_ok``."""
    rule = (B.tiles.dtype in (torch.int8, torch.bfloat16) and B.tiles.shape[-1] == B.tb
            and B.tb % 64 == 0 and B.tb <= 256 and F == 64 and H in (1, 2, 4))
    if rule != FG.flash_bwd_ring_shape_ok(K1._tile_mode(B.tiles, B.tb), B.tb, H, F):
        raise AssertionError("flash_bwd_ring_shape_ok disagrees with the rule")
    return rule


def _check_bwd(name, B, s1, s2, m, l, Wh, gO) -> tuple:
    """K4 and K5 against their plain versions (K5 on the plain t), each
    through the kernel its shape selects and, where that is the ring
    kernel, the single-stage one too: (max abs error, ring taken)."""
    ring = _bwd_ring_rule(B, Wh.shape[1], Wh.shape[2])
    ref = FG.flash_gat_bwd_row_plain(B, s1, s2, m, l, Wh, gO)
    plain = FG.flash_gat_bwd_col_plain(B, s1, s2, m, l, ref[0], Wh, gO)
    runs = [("", FG.flash_gat_bwd_row, FG.flash_gat_bwd_col)]
    if ring:
        runs.append((" single-stage", FG._flash_gat_bwd_row_single, FG._flash_gat_bwd_col_single))
    err = 0.0
    for label, row, col in runs:
        got = _flash_route(FG.flash_gat_bwd_row, ring if not label else False, f"K4{label} {name}",
                           lambda: row(B, s1, s2, m, l, Wh, gO))
        err = max(err, *(_check(f"K4{label} {name} {k}", g, r, GAT_TOL) for k, g, r in zip(("t", "u1", "u2"), got, ref)))
        got = _flash_route(FG.flash_gat_bwd_col, ring if not label else False, f"K5{label} {name}",
                           lambda: col(B, s1, s2, m, l, ref[0], Wh, gO))
        err = max(err, *(_check(f"K5{label} {name} {k}", g, r, GAT_TOL) for k, g, r in zip(("dWh", "ds2"), got, plain)))
    return err, ring


def _bwd_kernels_small(device, gen):
    """K4/K5 against their plain versions over the tile forms, split row
    and column runs and merged hybrid stats; K1/K2 on transposed plans;
    small GCN and GAT gradients through the kernels against the f32 edge
    path."""
    cases = [
        # name, n, prepare keywords, H, F
        ("int8-tb128-hub-H4-F64", 3001, dict(method="xla", gat_tb=128), 4, 64),
        ("packed-tb1024-H2-F16", 5000, dict(method="xla", gat_tb=1024), 2, 16),
        ("bf16-values-bsr-H1-F40", 2100, dict(method="bsr", rank1=False, tb=256), 1, 40),
        ("int8-tb128-H2-F100-two-feature-slices", 3001, dict(method="xla", gat_tb=128), 2, 100),
        ("int8-tb256-H3-F20-unaligned-rows", 3001, dict(method="xla"), 3, 20),
        ("int8-tb64-H2-F64", 3001, dict(method="xla", gat_tb=64), 2, 64),
        ("int8-tb192-H1-F64-ragged", 2900, dict(method="xla", gat_tb=192), 1, 64),
        ("bf16-values-bsr-tb128-H4-F64", 2100, dict(method="bsr", rank1=False, tb=128), 4, 64),
        ("int8-tb256-H4-F64", 4099, dict(method="xla"), 4, 64),
    ]
    took = {True: 0, False: 0}
    for i, (name, n, kw, H, F) in enumerate(cases):
        A = _random_graph(n, "values" in name, seed=40 + i, isolated=7)
        B = prepare_adjacency(A, for_gat=True, build_transpose=False, device=device, **kw).flash_tiles
        s1, s2, Wh = _scores(n, H, F, gen, device)
        gO = _scores(n, H, F, gen, device)[2]
        _, m, l = FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True)
        err, ring = _check_bwd(name, B, s1, s2, m, l, Wh, gO)
        took[ring] += 1
        msg = (f"  K4/K5 {name} [{'ring' if ring else 'single-stage'} kernels]: T={B.num_tiles} "
               f"row segments={B.segments.n_seg} split={B.segments.n_fin} col segments={B.col_segments.n_seg} "
               f"split={B.col_segments.n_fin}")
        if ring:
            Lt = B.live_t.ring
            msg += (f"; ring: live tiles {B.ring.step.shape[0]}, K4 work items {B.ring.segments.n_seg} "
                    f"split {B.ring.segments.n_fin}, K5 work items {Lt.segments.n_seg} split {Lt.segments.n_fin}")
        _log(msg + f" err {err:.3g}")
        if "hub" in name and not (B.segments.n_fin and B.col_segments.n_fin and B.ring.segments.n_fin
                                  and B.live_t.ring.segments.n_fin):
            raise AssertionError("the hub case must split a row run and a column run, on both schedules")
    if not (took[True] and took[False]):
        raise AssertionError("the small K4/K5 cases must reach both the ring and the single-stage kernels")

    A = _random_graph(3001, False, seed=50)
    part, rest = split_by_tile_density(A, 128, 40)
    B = K1.bsr_mask_from_sparse(part, tb=128, cover_rows=True, cover_cols=True, device=device)
    plan = K2.build_fused_plan(B, _drop_zero_val_edges(rest), attach_chunks=True)
    s1, s2, Wh = _scores(3001, 4, 64, gen, device)
    gO = _scores(3001, 4, 64, gen, device)[2]
    _, m, l = FG.flash_gat_hybrid_forward_plain(plan, s1, s2, Wh, return_stats=True)
    err = _check_bwd("hybrid-merged-stats", B, s1, s2, m, l, Wh, gO)[0]
    _log(f"  K4/K5 under merged hybrid stats (H=4, F=64): err {err:.3g}")

    for i, weighted in enumerate((False, True)):
        A = _random_graph(2600, weighted, seed=60 + i)
        prep = prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=40, device=device)
        g = torch.randn(A.n_rows, 64, generator=gen, device=device)
        gb = g.to(torch.bfloat16)  # the cotangent of K2's bf16 output
        e2 = _check("K2 on fused_t", K2.bsr_spmm_fused(prep.fused_t, gb),
                    K2.bsr_spmm_fused_plain(prep.fused_t, gb), K2_TOL)
        e1 = _check("K1 on bsr_t", K1.bsr_spmm(prep.bsr_t, g), K1.bsr_spmm_plain(prep.bsr_t, g), K1_TOL)
        _log(f"  transposed plans ({'values' if weighted else 'rank-1'}): K2 on fused_t err {e2:.3g}, "
             f"K1 on bsr_t err {e1:.3g}")

    A = _random_graph(3001, False, seed=70)
    x = torch.randn(3001, 32, generator=gen, device=device)
    edge = prepare_adjacency(A, method="xla", device=device)

    def grads(net, prep):
        net.zero_grad(set_to_none=True)
        net(prep, x).square().mean().backward()
        return {k: p.grad.clone() for k, p in net.named_parameters()}

    gcn = GCNModel(32, 64, 7, dropout=0.0, generator=torch.Generator().manual_seed(0)).to(device)
    gat = GATModel(32, 16, 7, nheads=4, dropout=0.0, generator=torch.Generator().manual_seed(0)).to(device)
    runs = [("GCN K2 + K2 on fused_t", gcn,
             prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=40, device=device), K2.bsr_spmm_fused),
            ("GAT K3 + K4/K5", gat, prepare_adjacency(A, method="xla", for_gat=True, device=device),
             FG.flash_gat_bwd_col),
            ("GAT K6 + K4/K5", gat, prepare_adjacency(A, method="xla", for_gat=True, gat_tb=128,
                                                      gat_rest_thresh=40, device=device), FG.flash_gat_bwd_col)]
    for name, net, prep, kern in runs:
        ref = grads(net, edge)
        before = kern.launches
        got = grads(net, prep)
        if kern.launches == before:
            raise AssertionError(f"small {name}: {kern.__name__} was not launched")
        err = 0.0
        for k, r in ref.items():
            scale = float(r.abs().max())
            torch.testing.assert_close(got[k], r, rtol=5e-2, atol=5e-2 * scale,
                                       msg=lambda mm: f"small {name} {k}: {mm}")
            err = max(err, float((got[k] - r).abs().max()) / max(scale, 1e-30))
        _log(f"  small {name} (3001 nodes) gradients vs f32 edge path: max err / max |grad| {err:.3g}")


def _int8_graph(n, seed, empty_rb=None, tb=128):
    """Weighted edges in (0, 1] plus hub rows: dense tiles and a sparse
    remainder. With ``empty_rb`` that row block gets no edge at all."""
    rng = np.random.default_rng(seed)
    h = np.stack([rng.integers(0, 150, 12 * n), rng.integers(0, n, 12 * n)])
    ei = np.unique(np.concatenate([rng.integers(0, n, (2, 4 * n)), h, h[::-1]], axis=1), axis=1)
    if empty_rb is not None:
        ei = ei[:, ei[0] // tb != empty_rb]
    v = rng.uniform(0.01, 1.0, ei.shape[1]).astype(np.float32)
    return SparseMatrix.from_coo(ei[0], ei[1], v, (n, n))


def _check_equal(name: str, out, ref) -> float:
    """int32 results must be identical; returns the max abs difference (0)."""
    torch.cuda.synchronize()
    if out.dtype != torch.int32 or out.shape != ref.shape or not torch.equal(out, ref):
        diff = (out.long() - ref.long()).abs().max().item() if out.shape == ref.shape else "shape"
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs diff {diff})")
    return 0.0


def _k7_route(B, Hq) -> str:
    """K7 through its wrapper, held to its plain version and, where the
    ring kernel took it, the single-stage kernel; the route taken."""
    before = K1.bsr_spmm_int8.launches_ring
    out = K1.bsr_spmm_int8(B, Hq)
    ref = K1.bsr_spmm_int8_plain(B, Hq)
    ring = K1.bsr_spmm_int8.launches_ring > before
    if ring != K1.int8_ring_shape_ok_k7(B.tb, Hq.shape[1], Hq.data_ptr()):
        raise AssertionError(f"K7 tb={B.tb} P={Hq.shape[1]} took the wrong route")
    name = f"K7 n={B.n_rows} tb={B.tb} P={Hq.shape[1]}"
    _check_equal(name, out, ref)
    if ring:
        _check_equal(name + " single-stage", K1._bsr_spmm_int8_single(B, Hq), out)
    return out, ("int8 ring (and single-stage)" if ring else "single-stage")


def phase_int8_kernels_small(device):
    """K7 and K8 equal to their plain versions and to a scipy integer
    product made on the host: tb 64-256 (K7 also 512), P in {8, 16, 32,
    100, 128}, a row block with no tile, dead chunk slots, split runs, both
    attach_chunks modes, each through the kernel its shape selects and the
    single-stage kernel too."""
    import scipy.sparse as sp

    c_a = generate_constants(0.0, 1.0, 8, signed=False, w_qbits=8)
    cases = [(3001, 128, 8, 2), (3001, 256, 16, None), (2600, 128, 100, 5), (4100, 256, 128, 1),
             (5165, 64, 32, 2)]
    split = ring_split = False
    for i, (n, tb, P, empty_rb) in enumerate(cases):
        A = _int8_graph(n, 80 + i, empty_rb, tb)
        aq = Q._quantize_vals(A.vals[: A.nnz], c_a).astype(np.int64)
        Aq = sp.coo_matrix((aq, (A.rows[: A.nnz], A.cols[: A.nnz])), shape=A.shape).tocsr()
        Hq_np = np.random.default_rng(i).integers(-127, 128, (n, P)).astype(np.int8)
        host = torch.from_numpy((Aq @ Hq_np.astype(np.int64)).astype(np.int32)).to(device)
        Hq = torch.from_numpy(Hq_np).to(device)
        B = Q.bsr_int8_from_sparse(A, c_a, tb=tb, device=device)
        out, route = _k7_route(B, Hq)
        _check_equal(f"K7 n={n} tb={tb} P={P} vs scipy", out[:n], host)
        if out.shape[0] != B.n_row_tiles * tb or (out[n:] != 0).any():
            raise AssertionError("K7 writes every row of every row block, zeros past n_rows")
        msg = (f"  K7/K8 n={n} tb={tb} P={P}: K7 {route} tiles={B.num_tiles} segments={B.segments.n_seg} "
               f"split_runs={B.segments.n_fin} (ring {B.edge_ring.segments.n_fin}) empty_rb={empty_rb};")
        part, rest = split_by_tile_density(A, tb, max(40 * tb * tb // 128**2, 2))
        B8 = Q.bsr_int8_from_sparse(part, c_a, tb=tb, cover_cols=True, device=device)
        rest_q = rest.with_vals(Q._quantize_vals(rest.vals, c_a))
        edge = Q.int8_edge_tiles(part, c_a, tb, K1.bsr_tile_keys(part, tb, cover_rows=True, cover_cols=True))
        for attach in (True, False):
            plan = K2.build_fused_plan(B8, rest_q, attach_chunks=attach, edge_tiles=edge)
            dead = int((plan.lrow == tb).sum())
            if not (plan.num_rest_chunks and dead):
                raise AssertionError("the K8 case needs chunks and dead slots")
            ring = K2.int8_ring_shape_ok(tb, P, plan.K, Hq.data_ptr())
            split |= plan.segments.n_fin > 0
            ring_split |= ring and plan.edge_ring.segments.n_fin > 0
            out = K2.bsr_spmm_int8_fused(plan, Hq)  # the kernel its shape selects
            _check_equal(f"K8 n={n} tb={tb} P={P} attach={attach}", out,
                         K2.bsr_spmm_int8_fused_plain(plan, Hq))
            _check_equal(f"K8 n={n} tb={tb} P={P} attach={attach} vs scipy", out, host)
            if ring:  # the single-stage kernel on the same plan
                _check_equal(f"K8 n={n} tb={tb} P={P} attach={attach} single-stage",
                             K2._bsr_spmm_int8_fused_single(plan, Hq), out)
            msg += (f" K8 attach={attach}: {'int8 ring (and single-stage)' if ring else 'single-stage'} "
                    f"tiles={B8.num_tiles} (carrying an edge {plan.edge_ring.n_tile_steps}) "
                    f"chunks={plan.num_rest_chunks} dead_slots={dead} kinds={sorted(set(plan.step_kind.tolist()))} "
                    f"split_runs={plan.segments.n_fin} (ring {plan.edge_ring.segments.n_fin});")
        _log(msg + " equal")
    if not (split and ring_split):
        raise AssertionError("no K8 case split a run on the single-stage and on the ring kernel")
    # K7 at freeze_gcn2_sparse's default tile height: the ring kernel's row halves
    for i, (n, P, empty_rb) in enumerate([(5165, 128, 1), (3001, 16, None), (4100, 100, 2)]):
        tb = 512
        A = _int8_graph(n, 90 + i, empty_rb, tb)
        aq = Q._quantize_vals(A.vals[: A.nnz], c_a).astype(np.int64)
        Aq = sp.coo_matrix((aq, (A.rows[: A.nnz], A.cols[: A.nnz])), shape=A.shape).tocsr()
        Hq_np = np.random.default_rng(10 + i).integers(-127, 128, (n, P)).astype(np.int8)
        B = Q.bsr_int8_from_sparse(A, c_a, device=device)
        Hq = torch.from_numpy(Hq_np).to(device)
        out, route = _k7_route(B, Hq)
        _check_equal(f"K7 n={n} tb={tb} P={P} vs scipy", out[:n],
                     torch.from_numpy((Aq @ Hq_np.astype(np.int64)).astype(np.int32)).to(device))
        L = B.edge_ring
        _log(f"  K7 n={n} tb={B.tb} P={P}: {route} tiles={B.num_tiles} row halves carrying an edge "
             f"{L.n_tile_steps} of {2 * B.num_tiles} work items={L.segments.n_seg} split_runs={L.segments.n_fin} "
             f"empty_rb={empty_rb}; equal")
    # the dense integer products that serve X @ W and the score matvecs
    rng = np.random.default_rng(3)
    shapes = [(1000, 100, 12), (2000, 100, 32), (17, 8, 2), (3001, 128, 100)]
    for M, K, N in shapes:
        us = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(device)
        sq = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8)).to(device)
        got = Q.matmul_unsigned_x_signed(us, sq)
        ref = (us.cpu().long() + 128) @ sq.cpu().long()
        if got.dtype != torch.int32 or not torch.equal(got.cpu().long(), ref):
            raise AssertionError(f"matmul_unsigned_x_signed {M}x{K}x{N} differs from the host integer product")
    _log(f"  matmul_unsigned_x_signed equals the host integer product at [M, K, N] in {shapes}")


def _slice_weights(rng, F, hidden, C):
    """Xavier-uniform (gain 1.414) conv weights [in, out] and a linear head."""
    def xavier(fan_in, fan_out):
        a = 1.414 * np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-a, a, (fan_in, fan_out)).astype(np.float32)

    b = 1.0 / np.sqrt(hidden)
    return {
        "conv1.weight": xavier(F, hidden),
        "conv2.weight": xavier(hidden, hidden),
        "head.weight": rng.uniform(-b, b, (C, hidden)).astype(np.float32),
        "head.bias": rng.uniform(-b, b, C).astype(np.float32),
    }


def _degree_ordered(A, data):
    """The degree order of ``A``, and the data renumbered in it."""
    perm = degree_order(A)
    A, inv = permute_graph(A, perm)
    return A, NodeClassificationData(
        inv[data.edge_index], data.x[perm], data.y[perm], data.train_mask[perm],
        data.val_mask[perm], data.test_mask[perm],
    )


def _slice_graph(cfg):
    """The power-law graph, sym_norm (fill-0 self-loops), degree order;
    the data (edges, x, y, masks) renumbered in the same order."""
    t0 = time.perf_counter()
    data = powerlaw_node_classification(**cfg)
    A, data = _degree_ordered(sym_norm(data.edge_index, data.num_nodes), data)
    return A, data, time.perf_counter() - t0


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_native_prepare(device, cfg=SLICE):
    """The host prepare of the GCN slice on the native library
    (runtime/native, built from csrc/sgrace_host.cpp by g++): sym_norm,
    RCM and the pallas plan, each against its numpy spec (identical
    arrays) and timed, and K9 on the native plan against K9 on the numpy
    plan. Returns the slice graph as _slice_graph, prepared on the native
    path."""
    if not native.available():
        raise AssertionError("the native host library did not build: the slice's host prepare needs it")
    _log(f"native host library: {native.lib_path()}")
    data, gen_s = _timed(lambda: powerlaw_node_classification(**cfg))
    n = data.num_nodes
    (ei, ew), nat_s = _timed(lambda: sym_norm_edges(data.edge_index, n))
    with native.disabled():
        (ei_np, ew_np), np_s = _timed(lambda: sym_norm_edges(data.edge_index, n))
    if not (np.array_equal(ei, ei_np) and np.array_equal(ew, ew_np)):
        raise AssertionError(f"sym_norm_edges: the native result differs from numpy's in "
                             f"{int((ew != ew_np).sum())} weights")
    del ei_np, ew_np
    _log(f"sym_norm_edges at n={n}, {data.edge_index.shape[1]} edges: native {nat_s:.3f} s, numpy {np_s:.3f} s, "
         f"identical ({ei.shape[1]} edges with the self-loops)")
    A0 = SparseMatrix.from_coo(ei[0], ei[1], ew, (n, n), sort=False)
    perm, rcm_s = _timed(lambda: rcm_order(A0))
    if not np.array_equal(np.sort(perm), np.arange(n)):
        raise AssertionError("rcm_order is not a permutation")
    band = bandwidth(permute_graph(A0, perm)[0])
    _log(f"rcm_order at n={n} (native): {rcm_s:.3f} s; bandwidth {bandwidth(A0)} before, {band} after")
    (A, data), order_s = _timed(lambda: _degree_ordered(A0, data))
    del A0, perm
    tiling = dict(rb=PALLAS_CFG["row_block"], cb=PALLAS_CFG["col_block"], be=PALLAS_CFG["edge_block"])
    plan, plan_s = _timed(lambda: K9.plan_spmm(A, **tiling))
    with native.disabled():
        plan_np, plan_np_s = _timed(lambda: K9.plan_spmm(A, **tiling))
    fields = ("lrow", "lcol", "val", "perm", "tile_rb", "tile_cb", "slot_idx", "slot_cv")
    differ = [f for f in fields if not torch.equal(getattr(plan, f), getattr(plan_np, f))]
    differ += [f for f in ("seg_rb", "seg_lo", "seg_hi", "seg_part")
               if not torch.equal(getattr(plan.segments, f), getattr(plan_np.segments, f))]
    if differ:
        raise AssertionError(f"plan_spmm: the native plan differs from numpy's in {differ}")
    _log(f"plan_spmm at {tiling} on the degree-ordered slice: native {plan_s:.3f} s, numpy {plan_np_s:.3f} s, "
         f"identical ({plan.num_groups} groups)")
    gen = torch.Generator(device=device).manual_seed(7)
    H = torch.randn(A.n_cols, HIDDEN, generator=gen, device=device)
    out = K9.spmm_plan(plan.to(device), H)
    if not torch.equal(out, K9.spmm_plan(plan_np.to(device), H)):
        raise AssertionError("K9 on the native plan differs from K9 on the numpy plan")
    _log("K9 on the native plan: torch.equal to K9 on the numpy plan")
    _log(f"the slice's host prepare takes the native path: generate {gen_s:.1f} s, sym_norm {nat_s:.1f} s, "
         f"degree order {order_s:.1f} s")
    return A, data, gen_s + nat_s + order_s


def phase_slice_prepare(device, cfg=SLICE, graph=None):
    """One prepare for serving and training: serving reads the forward
    plans, training also the transposed ones. ``graph`` is _slice_graph's
    result where the caller made it."""
    A, data, gen_s = graph or _slice_graph(cfg)
    t0 = time.perf_counter()
    prep = prepare_adjacency(A, method="hybrid", tb=SLICE_SPLIT[0], rest_thresh=SLICE_SPLIT[1], device=device)
    prep_s = time.perf_counter() - t0
    f, ft = prep.fused, prep.fused_t
    _log(f"slice graph: n={A.n_rows} nnz={A.nnz} (incl. zero-valued self-loops) "
         f"generate+sym_norm+degree-order {gen_s:.1f} s")
    _log(f"slice prepare (forward and transposed plans; the forward plans alone took 5.4 s in earlier runs): "
         f"{prep_s:.1f} s kind={prep.kind} tb={prep.bsr.tb} "
         f"tiles={prep.bsr.num_tiles} form={prep.bsr.tiles.dtype}{list(prep.bsr.tiles.shape[1:])} "
         f"rank1={prep.r1_row is not None} rest_edges={prep.rest.nnz if prep.rest is not None else 0} "
         f"rest_chunks={f.num_rest_chunks} K={f.K} steps={f.num_steps} "
         f"segments={f.segments.n_seg} split_runs={f.segments.n_fin}; "
         f"fused_t: steps={ft.num_steps} segments={ft.segments.n_seg} split_runs={ft.segments.n_fin}")
    for name, B, L in (("fused", prep.bsr, f.ring), ("fused_t", prep.bsr_t, ft.ring),
                       ("bsr", prep.bsr, prep.bsr.ring), ("bsr_t", prep.bsr_t, prep.bsr_t.ring)):
        S = L.segments
        dead = B.num_tiles - int(B.live.sum())
        _log(f"ring schedule of {name}: {dead} of {B.num_tiles} tiles are empty cover tiles "
             f"({dead / B.num_tiles:.3f}); tile products kept {L.n_tile_steps}, skipped {L.n_dead_tile_steps}; "
             f"live steps {L.step.shape[0]}, work items {S.n_seg} at RING_SEG_STEPS={K1.RING_SEG_STEPS} "
             f"(longest {int((S.seg_hi - S.seg_lo).max())} steps), split runs {S.n_fin}, partials {S.n_part}")
    for B in (prep.bsr, prep.bsr_t):
        nonzero = B.tiles.view(B.num_tiles, -1).any(dim=1)
        if (nonzero & ~B.live).any():
            raise AssertionError("a tile with a nonzero must be flagged live")
        if (B.live & ~nonzero).any():
            _log(f"  {int((B.live & ~nonzero).sum())} live-flagged tiles hold no nonzero (allowed: extra work only)")
    return A, data, prep


def _random_csr(rng, n_rows, n_cols, nnz):
    """(rowptr, cols) of ``nnz`` distinct positions, sorted by row and column."""
    keys = np.sort(rng.choice(n_rows * n_cols, nnz, replace=False))
    rows, cols = keys // n_cols, keys % n_cols
    return np.searchsorted(rows, np.arange(n_rows + 1)), cols


def _write_csr_text(path, rowptr, cols, vals=None) -> None:
    """The reference's 3-line CSR text; no values line for a binary matrix."""
    lines = [",".join(map(str, rowptr)), ",".join(map(str, cols))]
    if vals is not None:
        lines.append(",".join(f"{v:.9g}" for v in vals))  # 9 digits: every float32 reads back exactly
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _same_matrix(name, a, b) -> None:
    for k in ("rows", "cols", "vals"):
        if not np.array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k))):
            raise AssertionError(f"{name}: {k} differ")
    if (a.shape, a.nnz) != (b.shape, b.nnz):
        raise AssertionError(f"{name}: shape or nnz differ")


def phase_reference_format(device):
    """The reference's own input files at pubmed's descriptor, written from
    a seed into a temporary directory: the adjacency (3-line CSR text with
    values), the binary features (CSR text without a values line) and the
    weights (dense text, M x REF_HIDDEN). Parsed by the native and the
    numpy parser (identical), then through load_reference_dataset; then the
    reference's one call ReLU(A (X W)): X W on the edge path (gnn_layer's
    sparse-feature branch), the aggregation through prepare_adjacency
    (auto: the cost model's kind; the dense bf16 matrix passes 512 MiB)
    and agg_matmul (its kernel once), against the all-edge-path gnn_layer
    and spmm_dense_rhs."""
    desc = GIO.REFERENCE_DATASETS[REF_DATASET]
    n, m = desc["N_adj"], desc["M_fea"]
    rng = np.random.default_rng(11)
    adj_ptr, adj_cols = _random_csr(rng, n, n, desc["NNZ_adj"])
    adj_vals = rng.uniform(0.05, 1.0, desc["NNZ_adj"]).astype(np.float32)
    fea_ptr, fea_cols = _random_csr(rng, n, m, desc["NNZ_fea"])
    W = (rng.standard_normal((m, REF_HIDDEN)) * 0.1).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = lambda kind: os.path.join(d, f"{REF_DATASET}_{kind}.txt")
        t0 = time.perf_counter()
        _write_csr_text(path("adj"), adj_ptr, adj_cols, adj_vals)
        _write_csr_text(path("feat"), fea_ptr, fea_cols)
        with open(path("weights"), "w") as f:
            f.write("\n".join(",".join(f"{v:.9g}" for v in row) for row in W) + "\n")
        write_s = time.perf_counter() - t0
        times = {}
        parsed = {}
        for kind, cols in (("adj", n), ("feat", m)):
            parsed[kind], times[f"{kind} native"] = _timed(lambda: GIO.load_csr_text(path(kind), cols))
            with native.disabled():
                spec, times[f"{kind} numpy"] = _timed(lambda: GIO.load_csr_text(path(kind), cols))
            _same_matrix(f"{kind} parse native vs numpy", parsed[kind], spec)
        w_nat, times["weights native"] = _timed(lambda: GIO.load_dense_text(path("weights")))
        with native.disabled():
            w_np, times["weights numpy"] = _timed(lambda: GIO.load_dense_text(path("weights")))
        (adj, fea, w), load_s = _timed(lambda: GIO.load_reference_dataset(REF_DATASET, d))
    _same_matrix("load_reference_dataset adjacency", adj, parsed["adj"])
    _same_matrix("load_reference_dataset features", fea, parsed["feat"])
    if not (np.array_equal(w, w_nat) and np.array_equal(w, w_np) and np.array_equal(w, W)):
        raise AssertionError("the weights file does not read back as written")
    if not (np.array_equal(np.asarray(adj.vals)[: adj.nnz], adj_vals) and adj.nnz == desc["NNZ_adj"]
            and fea.nnz == desc["NNZ_fea"] and (np.asarray(fea.vals)[: fea.nnz] == 1).all()):
        raise AssertionError("the adjacency or the features do not read back as written")
    _log(f"reference-format files at {REF_DATASET}'s descriptor (N {n}, M {m}, {adj.nnz} adjacency and {fea.nnz} "
         f"feature nonzeros, weights {W.shape[0]} x {W.shape[1]}): written in {write_s:.2f} s; parse seconds "
         + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + f"; load_reference_dataset {load_s:.4f} s")

    prep, prep_s = _timed(lambda: prepare_adjacency(adj, device=device))
    kern = _agg_kernel(prep)
    _log(f"reference-format {REF_DATASET}: auto took {prep.kind} ({_choice(prep)})")
    fea_d, W_d = fea.to(device), torch.from_numpy(w).to(device)

    def forward():
        return relu_hw(agg_matmul(prep, spmm(fea_d, W_d)))

    forward()  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = forward()
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    _all_ring("reference-format forward")
    want = {k.__name__: 0 for k in KERNELS} | ({kern: 1} if kern else {})
    if launches != want:
        raise AssertionError(f"reference-format forward launches {launches}, expected {want}")
    agg_ms = cuda_ms(forward)
    adj_d = adj.to(device)
    edge = gnn_layer(adj_d, fea_d, W_d, relu=True)
    dense = relu_hw(spmm_dense_rhs(adj_d, torch.from_numpy(fea.to_dense()).to(device), W_d))
    scale = float(edge.abs().max())
    errs = []
    for name, ref in (("the all-edge-path gnn_layer", edge), ("spmm_dense_rhs", dense)):
        torch.testing.assert_close(out, ref, rtol=REF_TOL, atol=REF_TOL * scale,
                                   msg=lambda msg: f"reference-format forward vs {name}: {msg}")
        errs.append(f"{float((out - ref).abs().max()) / scale:.3g} against {name}")
    layout = "" if prep.bsr is None else (
        f", tb {prep.bsr.tb}, rank1 {prep.r1_row is not None}, {prep.bsr.num_tiles} tiles, "
        f"{prep.rest.nnz if prep.rest is not None else 0} remainder edges")
    _log(f"reference-format forward ReLU(A (X W)) on {REF_DATASET}: prepare {prep_s:.2f} s (kind {prep.kind}"
         f"{layout}); first forward {fwd_ms:.3f} ms, "
         f"forward {agg_ms:.4f} ms (CUDA events, median of 10); launches {launches}; max err / max |out| "
         + ", ".join(errs) + f" (tolerance {REF_TOL})")
    return {kern: launches[kern]} if kern else {}


def phase_gat_agg(A, B, device):
    """gat_attention_agg at the GAT slice: one head, F = 64, on the slice's
    dense attention part (A, edge list) and its int8 mask tiles (B). The
    forward (K3) must be torch.equal to flash_gat_forward; the gradients of
    s1, s2 and Wh (the edge backward) are held against autograd through the
    f32 edge path (gat_attention_agg_ref) and against gat_attention_agg_fused
    (K3 forward, K4/K5 backward)."""
    n, F = A.n_rows, GAT_HIDDEN
    gen = torch.Generator(device=device).manual_seed(5)
    s1, s2 = (torch.randn(n, generator=gen, device=device) for _ in range(2))
    Wh = torch.randn(n, F, generator=gen, device=device)
    v = torch.randn(n, F, generator=gen, device=device)
    A_d = A.to(device)

    def run(fn):
        xs = [t.clone().requires_grad_(True) for t in (s1, s2, Wh)]
        out = fn(*xs)
        (out * v).sum().backward()
        return out.detach(), [x.grad for x in xs]

    agg = lambda a, b, c: FG.gat_attention_agg(A_d, B, a, b, c)
    run(agg)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out, grads = run(agg)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    _all_ring("gat_attention_agg")
    want = {k.__name__: 0 for k in KERNELS} | {"flash_gat_forward": 1}
    if launches != want:
        raise AssertionError(f"gat_attention_agg forward + backward launches {launches}, expected {want}")
    ms = cuda_ms(lambda: run(agg), reps=5)
    with torch.no_grad():
        if not torch.equal(out, FG.flash_gat_forward(B, s1, s2, Wh)):
            raise AssertionError("gat_attention_agg's forward differs from flash_gat_forward on the same inputs")
    _, fused = run(lambda a, b, c: FG.gat_attention_agg_fused(B, a, b, c))
    _, ref = run(lambda a, b, c: FG.gat_attention_agg_ref(A_d, a, b, c))
    errs = []
    for name, g, f, r in zip(("ds1", "ds2", "dWh"), grads, fused, ref):
        scale = float(r.abs().max())
        for what, want_g, tol in (("the f32 edge path", r, AGG_REF_TOL), ("K3/K4/K5", f, AGG_FUSED_TOL)):
            torch.testing.assert_close(g, want_g, rtol=tol, atol=tol * scale,
                                       msg=lambda msg: f"gat_attention_agg {name} vs {what}: {msg}")
        errs.append(f"{name} {float((g - r).abs().max()) / scale:.3g} / {float((g - f).abs().max()) / scale:.3g}")
    _log(f"gat_attention_agg at the GAT slice's dense part (n={n}, {A.nnz} edges, {int(B.live.sum())} live tiles of "
         f"{B.tb}, H=1, F={F}): forward + backward {ms:.3f} ms (CUDA events, median of 5; first call {first_ms:.3f} "
         f"ms); launches {launches}; forward torch.equal to flash_gat_forward; max err / max |grad| against the "
         f"f32 edge path / K3-K4-K5: " + ", ".join(errs) + f" (tolerances {AGG_REF_TOL} / {AGG_FUSED_TOL})")
    return {"flash_gat_forward": launches["flash_gat_forward"]}


def _live_plan(plan):
    """``plan`` for the single-stage K2 with the steps that do no work
    taken out (what the ring schedule drops): a tile step on an empty tile
    goes, a tile + chunk step on one keeps its chunk."""
    S = plan.num_steps
    live = plan.B.live[plan.step_tile.long()]
    tile_part = (plan.step_kind != 1) & live
    chunk_part = plan.step_kind >= 1
    keep = tile_part | chunk_part
    kind = torch.where(tile_part & chunk_part, 3, torch.where(tile_part, 0, 1)).to(torch.int32)
    rb = plan.step_rb[:S][keep]
    return dataclasses.replace(
        plan, step_rb=torch.cat([rb, plan.step_rb[S:]]), step_cb=plan.step_cb[keep].contiguous(),
        step_tile=plan.step_tile[keep].contiguous(), step_chunk=plan.step_chunk[keep].contiguous(),
        step_kind=kind[keep].contiguous(),
        segments=K1.run_segments(rb.cpu().numpy(), plan.B.n_row_tiles, plan.B.tiles.device),
    )


def _live_tiles(B):
    """``B`` for the single-stage K1 with the empty cover tiles taken out."""
    live = B.live
    rb = B.tile_rb[live].contiguous()
    return dataclasses.replace(
        B, tiles=B.tiles[live].contiguous(), tile_rb=rb, tile_cb=B.tile_cb[live].contiguous(),
        segments=K1.run_segments(rb.cpu().numpy(), B.n_row_tiles, B.tiles.device),
    )


def phase_kernels_slice(A, prep, device):
    """Both kernels at the slice's shapes (P = 128): error and times, the
    bound, and the library call beside them; the single-stage kernels in
    the same run (through their private entries) on every step, on the live
    steps alone (step 1 of the redesign) and on H staged once in bf16
    (steps 1-2); the ring kernels on the transposed plans and over
    RING_SEG_STEPS."""
    gen = torch.Generator(device=device).manual_seed(1)
    H = torch.randn(prep.A.n_cols, HIDDEN, generator=gen, device=device)
    lib_ms, lib = _sparse_mm_ms(A, H)
    e = _check("agg_matmul (K2) against torch.sparse.mm", agg_matmul(prep, H), lib, K2_TOL)
    _log(f"agg_matmul (K2, bf16) against the library product (f32): max abs err {e:.3g}")
    del lib
    B, plan = prep.bsr, prep.fused
    n_ct_rows = -(-B.n_cols // B.tb) * B.tb
    stage_ms = {
        "bsr_spmm_fused": cuda_ms(lambda: K1._stage_h(H, plan.colscale, n_ct_rows, B.n_cols)),
        "bsr_spmm": cuda_ms(lambda: K1._stage_h(H, None, n_ct_rows, B.n_cols)),
    }
    _log(f"pre-pass (H rounded to bf16 once, [n={n_ct_rows}, P={HIDDEN}]): with the column scale "
         f"{stage_ms['bsr_spmm_fused']:.4f} ms, without {stage_ms['bsr_spmm']:.4f} ms (inside the ring kernels' times)")
    live_plan, live_B = _live_plan(plan), _live_tiles(B)
    # the staged operand of the single-stage K2: scales already applied
    staged_plan = dataclasses.replace(live_plan, colscale=None, slot_scale=torch.ones_like(plan.slot_scale))
    rec = {}
    for name, kern, single, plain, op, live_op, staged_op, cs, tol in (
        ("bsr_spmm_fused", K2.bsr_spmm_fused, K2._bsr_spmm_fused_single, K2.bsr_spmm_fused_plain,
         plan, live_plan, staged_plan, plan.colscale, K2_TOL),
        ("bsr_spmm", K1.bsr_spmm, K1._bsr_spmm_single, K1.bsr_spmm_plain, B, live_B, live_B, None, K1_TOL),
    ):
        ref = plain(op, H)
        _reset_counts()
        out = kern(op, H)
        err = _check(f"{name} at slice shapes", out, ref, tol)
        _all_ring(f"{name} at slice shapes")
        staged = lambda: single(staged_op, K1._stage_h(H, cs, n_ct_rows, B.n_cols))
        _check(f"{name} single-stage at slice shapes", single(op, H), ref, tol)
        _check(f"{name} single-stage on the live steps", single(live_op, H), ref, tol)
        _check(f"{name} single-stage on the live steps, H staged", staged(), ref, tol)
        # in turns within one call: ring, single-stage, single-stage, ring
        ms = [cuda_ms(lambda: kern(op, H)), 0.0]
        earlier = [cuda_ms(lambda: single(op, H)), cuda_ms(lambda: single(op, H))]
        ms[1] = cuda_ms(lambda: kern(op, H))
        step1_ms = cuda_ms(lambda: single(live_op, H))
        step12_ms = cuda_ms(staged)
        plain_ms = cuda_ms(lambda: plain(op, H), reps=5)
        bound = _agg_bound(B, H, out, "bf16", plan=op if op is plan else None)
        rec[name] = dict(max_abs_err=err, ms=min(ms), plain_ms=plain_ms, **bound, library_ms=lib_ms,
                         earlier_ms=min(earlier))
        _log(f"{name} at slice shapes [n={prep.A.n_rows}, P={HIDDEN}]: ring kernel {ms[0]:.4f} / {ms[1]:.4f} ms "
             f"(pre-pass included), single-stage kernel {earlier[0]:.4f} / {earlier[1]:.4f} ms, "
             f"plain {plain_ms:.4f} ms (median of 5), bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, "
             f"library {lib_ms:.4f} ms, max abs err {err:.3g}")
        _log(f"  steps of the redesign on {name}: single-stage on all steps {min(earlier):.4f} ms; on the live "
             f"steps alone (step 1) {step1_ms:.4f} ms; live steps and H staged once (steps 1-2) {step12_ms:.4f} ms "
             f"pre-pass included; ring kernel (steps 1-5) {min(ms):.4f} ms")
    del live_plan, live_B, staged_plan
    # where K2's time goes: the same tiles without the remainder chunks, and the kernels by name
    bare = K2.build_fused_plan(B, None, r1_row=prep.r1_row.cpu().numpy(), r1_col=prep.r1_col.cpu().numpy())
    _check("bsr_spmm_fused without the remainder", K2.bsr_spmm_fused(bare, H),
           K2.bsr_spmm_fused_plain(bare, H), K2_TOL)
    _log(f"bsr_spmm_fused on the same tiles without the {plan.num_rest_chunks} remainder chunks: "
         f"ring kernel {cuda_ms(lambda: K2.bsr_spmm_fused(bare, H)):.4f} ms")
    del bare
    _profile_forward(lambda: K2.bsr_spmm_fused(plan, H), "bsr_spmm_fused", "1 call")
    _profile_forward(lambda: K1.bsr_spmm(B, H), "bsr_spmm", "1 call")

    # the transposed plans, as the backward launches them
    g = torch.randn(prep.A.n_rows, HIDDEN, generator=gen, device=device)
    gb = g.to(torch.bfloat16)  # the cotangent of K2's bf16 output arrives in f32; both are taken
    for name, kern, single, plain, op, arg, tol in (
        ("bsr_spmm_fused on fused_t", K2.bsr_spmm_fused, K2._bsr_spmm_fused_single, K2.bsr_spmm_fused_plain,
         prep.fused_t, g, K2_TOL),
        ("bsr_spmm on bsr_t", K1.bsr_spmm, K1._bsr_spmm_single, K1.bsr_spmm_plain, prep.bsr_t, g, K1_TOL),
        ("bsr_spmm_fused on fused_t, bf16 cotangent", K2.bsr_spmm_fused, K2._bsr_spmm_fused_single,
         K2.bsr_spmm_fused_plain, prep.fused_t, gb, K2_TOL),
    ):
        err = _check(name, kern(op, arg), plain(op, arg), tol)
        ms_t, single_t = cuda_ms(lambda: kern(op, arg)), cuda_ms(lambda: single(op, arg))
        _log(f"{name}: ring kernel {ms_t:.4f} ms, single-stage kernel {single_t:.4f} ms, max abs err {err:.3g}")

    # RING_SEG_STEPS: the same live steps cut into shorter or longer work items
    for name, kern, op, sched, tol, ref in (
        ("bsr_spmm_fused", K2.bsr_spmm_fused, plan, plan.ring, K2_TOL, K2.bsr_spmm_fused_plain(plan, H)),
        ("bsr_spmm on bsr_t", K1.bsr_spmm, prep.bsr_t, prep.bsr_t.ring, K1_TOL, K1.bsr_spmm_plain(prep.bsr_t, g)),
    ):
        arg = H if op is plan else g
        times = []
        for seg in (8, 16, 32, 64):
            L = K1.recut_live_schedule(sched, op.B.n_row_tiles if op is plan else op.n_row_tiles, seg)
            cut = dataclasses.replace(op, ring=L)
            _check(f"{name} at RING_SEG_STEPS={seg}", kern(cut, arg), ref, tol)
            times.append(f"{seg}: {cuda_ms(lambda: kern(cut, arg)):.4f} ms ({L.segments.n_seg} items, "
                         f"{L.segments.n_part} partials)")
        _log(f"{name} over RING_SEG_STEPS (chosen {K1.RING_SEG_STEPS}): " + "; ".join(times))
    return rec


def _sparse_mm_ms(A, H) -> tuple:
    """The library yardstick of K1/K2: one ``torch.sparse.mm`` on the CSR
    form of the same normalised adjacency with the same H (float32). Timed
    here and used nowhere in the package. Returns (ms, the product)."""
    rows = A.rows[: A.nnz].astype(np.int64)
    crow = torch.from_numpy(np.searchsorted(rows, np.arange(A.n_rows + 1))).to(H.device)
    csr = torch.sparse_csr_tensor(
        crow, torch.from_numpy(A.cols[: A.nnz].astype(np.int64)).to(H.device),
        torch.from_numpy(A.vals[: A.nnz].astype(np.float32)).to(H.device), size=A.shape)
    ref = torch.sparse.mm(csr, H)
    ms = cuda_ms(lambda: torch.sparse.mm(csr, H))
    _log(f"library call torch.sparse.mm (CSR, f32, nnz={A.nnz}) on [n={A.n_rows}, P={H.shape[1]}]: {ms:.4f} ms")
    return ms, ref


def _plain_forward(net, prep, x):
    """The model's forward with every aggregation on the plain K2."""
    h = x
    for i in range(net.num_layers):
        w = getattr(net, f"conv{i + 1}").weight
        h = K2.bsr_spmm_fused_plain(prep.fused, torch.matmul(h, w)).to(h.dtype)
        if i < net.num_layers - 1:
            h = torch.relu(h)
    return net.head(h)


def phase_slice_serve(A, x, prep, device, cfg=SLICE):
    C = cfg["num_classes"]
    net = _gcn_net(cfg).to(device).eval()
    x = torch.from_numpy(x).to(device)
    prep_k1 = dataclasses.replace(prep, fused=None, fused_t=None)  # fuse=False view
    with torch.no_grad():
        net(prep, x)  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        ms, per_request = [], []
        for _ in range(REQUESTS):
            before = K2.bsr_spmm_fused.launches
            t0 = time.perf_counter()
            logits = net(prep, x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_request.append(K2.bsr_spmm_fused.launches - before)
        t0 = time.perf_counter()
        logits_k1 = net(prep_k1, x)
        torch.cuda.synchronize()
        k1_ms = (time.perf_counter() - t0) * 1e3
        launches = {"bsr_spmm_fused": K2.bsr_spmm_fused.launches, "bsr_spmm": K1.bsr_spmm.launches}
        _all_ring("slice serving")
        peak = torch.cuda.max_memory_allocated()
    _log("slice forwards (K2 route): " + ", ".join(f"{m:.3f}" for m in ms) + " ms")
    _log(f"slice forward (K1 route, fuse=False view): {k1_ms:.3f} ms")
    _log(f"launches in the serving run: {launches} (K2 per request: {per_request}), all on the ring kernels")
    _log(f"peak device memory in the serving run: {peak / 2**30:.3f} GiB")
    if per_request != [2] * REQUESTS:
        raise AssertionError(f"K2 launches per request {per_request}, expected 2 each")
    if launches["bsr_spmm"] != 2:
        raise AssertionError(f"K1 launched {launches['bsr_spmm']} times, expected 2")

    with torch.no_grad():
        _profile_forward(lambda: net(prep, x), "GCN slice")
        H1 = torch.matmul(x, net.conv1.weight)
        agg_ms = cuda_ms(lambda: agg_matmul(prep, H1))
        ref = _plain_forward(net, prep, x)
    _log(f"slice aggregation (layer-1 input, K2): {agg_ms:.4f} ms, "
         f"{A.nnz / (agg_ms * 1e-3) / 1e6:.1f} M edges/s")
    if logits.shape != (A.n_rows, C):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    e2 = _check("slice logits K2 vs plain-K2 forward", logits, ref, K2_TOL)
    e1 = _check("slice logits K1 route vs plain-K2 forward", logits_k1, ref, K2_TOL)
    _log(f"slice logits: max abs err K2 {e2:.3g}, K1 route {e1:.3g} "
         f"(|logits| max {float(ref.abs().max()):.3g})")
    return launches, logits


def _gat_weights(rng, F, hidden, H, C):
    """Xavier-uniform (gain 1.414) GAT weights [in, out] and attention
    vectors [2*out, 1], and a linear head."""
    def xavier(fan_in, fan_out):
        a = 1.414 * np.sqrt(6.0 / (fan_in + fan_out))
        return torch.from_numpy(rng.uniform(-a, a, (fan_in, fan_out)).astype(np.float32))

    b = 1.0 / np.sqrt(hidden)
    return {
        "conv1.weight": xavier(F, hidden * H),
        "conv1.attention": xavier(2 * hidden * H, 1),
        "conv2.weight": xavier(hidden * H, hidden),
        "conv2.attention": xavier(2 * hidden, 1),
        "head.weight": torch.from_numpy(rng.uniform(-b, b, (C, hidden)).astype(np.float32)),
        "head.bias": torch.from_numpy(rng.uniform(-b, b, C).astype(np.float32)),
    }


def phase_gat_prepare(A, device, label, split=None):
    """for_gat prepare and its layout: the hybrid split ``split`` = (tb,
    threshold) where given, else the layout chooser's."""
    t0 = time.perf_counter()
    kw = {} if split is None else dict(gat_tb=split[0], gat_rest_thresh=split[1])
    prep = prepare_adjacency(A, method="xla", for_gat=True, device=device, **kw)
    prep_s = time.perf_counter() - t0
    B, plan = prep.flash_tiles, prep.gat_plan
    msg = (f"{label} GAT prepare: {prep_s:.1f} s tb={B.tb} tiles={B.num_tiles} "
           f"form={B.tiles.dtype}{list(B.tiles.shape[1:])}")
    if plan is not None:
        msg += (f" hybrid: rest_edges={prep.gat_rest.nnz} rest_chunks={plan.num_rest_chunks} "
                f"K={plan.K} steps={plan.num_steps} segments={plan.segments.n_seg} "
                f"split_runs={plan.segments.n_fin}")
    else:
        msg += f" full cover: segments={B.segments.n_seg} split_runs={B.segments.n_fin}"
    _log(msg)
    return prep


def _timed_once(fn):
    """(fn(), its device ms): one call between two CUDA events, for a plain
    version that takes seconds at the slice's sizes."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def phase_gat_kernels_slice(prep, device):
    """K6 on the slice's plan and K3 on its tile set at H=4, F=64 (the first
    GAT layer) and H=1, F=64 (the second): the ring kernel and the
    single-stage kernel in one run, in turns (ring, single, single, ring),
    against the plain versions; then K4 and K5 under K6's stats."""
    gen = torch.Generator(device=device).manual_seed(2)
    rec = {}
    plan = prep.gat_plan
    n = prep.A.n_cols
    L3, L6 = plan.B.ring, plan.ring
    _log(f"GAT slice live schedules: K3 {L3.step.shape[0]} live tiles of {plan.B.num_tiles} "
         f"({L3.n_dead_tile_steps} empty cover tiles dropped), {L3.segments.n_seg} segments, "
         f"{L3.segments.n_fin} split runs; K6 {L6.step.shape[0]} live steps of {plan.num_steps}, chunk slabs "
         f"{int(((L6.step[:, 3] + 63) // 64).sum())}, {L6.segments.n_seg} segments, {L6.segments.n_fin} split runs")
    for H in (GAT_HEADS, 1):
        s1, s2, Wh = _scores(n, H, GAT_HIDDEN, gen, device)
        cast_ms = cuda_ms(lambda: Wh.to(torch.bfloat16))
        for name, kern, single, plain, op in (
            ("flash_gat_hybrid_forward", FG.flash_gat_hybrid_forward, FG._flash_gat_hybrid_forward_single,
             FG.flash_gat_hybrid_forward_plain, plan),
            ("flash_gat_forward", FG.flash_gat_forward, FG._flash_gat_forward_single, FG.flash_gat_forward_plain,
             plan.B),
        ):
            label = f"{name} at slice shapes H={H}"
            ref, plain_ms = _timed_once(lambda: plain(op, s1, s2, Wh, return_stats=True))
            res = _flash_route(kern, True, label, lambda: kern(op, s1, s2, Wh, return_stats=True))
            err = _check_flash(label, res, ref)
            _check_flash(f"{label}, single-stage kernel", single(op, s1, s2, Wh, return_stats=True), ref)
            del res
            ms = [cuda_ms(lambda: kern(op, s1, s2, Wh)), 0.0]
            earlier = [cuda_ms(lambda: single(op, s1, s2, Wh)), cuda_ms(lambda: single(op, s1, s2, Wh))]
            ms[1] = cuda_ms(lambda: kern(op, s1, s2, Wh))
            out = ref[0]
            bound = _flash_bound(plan.B, (s1, s2, Wh, out), H, GAT_HIDDEN, 1, plan=plan if op is plan else None)
            msg = (f"{label} [n={prep.A.n_rows}, F={GAT_HIDDEN}]: ring kernel {ms[0]:.4f} / {ms[1]:.4f} ms "
                   f"(the Wh cast to bf16, {cast_ms:.4f} ms alone, included), single-stage kernel "
                   f"{earlier[0]:.4f} / {earlier[1]:.4f} ms, bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, "
                   f"max abs err {err:.3g}")
            if H == GAT_HEADS:
                rec[name] = dict(max_abs_err=err, ms=min(ms), plain_ms=plain_ms, **bound, library_ms=None,
                                 earlier_ms=min(earlier))
                msg += f", plain {plain_ms:.4f} ms (once, with the stats)"
            _log(msg)
            del ref, out
    rec.update(_gat_bwd_slice(plan, n, gen, device))
    return rec


def _gat_bwd_slice(plan, n, gen, device):
    """K4 and K5 on the slice's plan tiles under K6's merged stats, at H=4
    and H=1, F=64, on the operands ``flash_gat_backward`` hands them
    (``FG.bwd_operands``: padded to the tile grid, Wh and gO in bf16): the
    ring kernel and the single-stage kernel in turns (ring, single, single,
    ring), each against the plain version; the f32-in call (the two casts to
    bf16 included) beside them. Bounds count the bf16 operands and the live
    tiles."""
    rec = {}
    B = plan.B
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Bt = B.live_t  # K5's transposed live tiles, built once and kept with B
    torch.cuda.synchronize()
    _log(f"GAT slice transposed live tiles (K5's ring): {Bt.num_tiles} of {B.num_tiles} tiles, "
         f"{RL.nbytes(Bt.tiles) / 1e9:.4f} GB of tiles + {RL.sched_bytes(Bt.ring) / 1e6:.3f} MB of schedule, "
         f"built in {time.perf_counter() - t0:.2f} s; K4 {B.ring.segments.n_seg} work items "
         f"({B.ring.segments.n_fin} split runs), K5 {Bt.ring.segments.n_seg} ({Bt.ring.segments.n_fin} split runs)")
    for H in (GAT_HEADS, 1):
        s1, s2, Wh = _scores(n, H, GAT_HIDDEN, gen, device)
        _, m, l = FG.flash_gat_hybrid_forward(plan, s1, s2, Wh, return_stats=True)
        gO = torch.randn(Wh.shape, generator=gen, device=device)
        ops = FG.bwd_operands(B, s1, s2, Wh, gO, m, l)
        t = FG.flash_gat_bwd_row_plain(B, **ops)[0]
        for name, kern, single, plain, args, T, products in (
            ("flash_gat_bwd_row", FG.flash_gat_bwd_row, FG._flash_gat_bwd_row_single, FG.flash_gat_bwd_row_plain,
             dict(ops), B, 1),
            ("flash_gat_bwd_col", FG.flash_gat_bwd_col, FG._flash_gat_bwd_col_single, FG.flash_gat_bwd_col_plain,
             dict(ops, t=t), Bt, 2),
        ):
            label = f"{name} at slice shapes H={H}"
            ref, plain_ms = _timed_once(lambda: plain(B, **args))
            outs = _flash_route(kern, True, label, lambda: kern(B, **args))
            err = max(_check(label, g, r, GAT_TOL) for g, r in zip(outs, ref))
            for g, r in zip(single(B, **args), ref):
                _check(f"{label}, single-stage kernel", g, r, GAT_TOL)
            ms = [cuda_ms(lambda: kern(B, **args)), 0.0]
            earlier = [cuda_ms(lambda: single(B, **args)), cuda_ms(lambda: single(B, **args))]
            ms[1] = cuda_ms(lambda: kern(B, **args))
            f32_in = dict(args, Wh=Wh, gO=gO)  # the f32 operands: each call casts them to bf16
            f32_ms = cuda_ms(lambda: kern(B, **f32_in))
            # K4: the q product; K5: the q product and p^T @ gO
            bound = _flash_bound(T, (*args.values(), *outs), H, GAT_HIDDEN, products)
            msg = (f"{label} [n={n}, live tiles {int(B.live.sum())}, F={GAT_HIDDEN}, bf16 Wh/gO]: ring kernel "
                   f"{ms[0]:.4f} / {ms[1]:.4f} ms, single-stage kernel {earlier[0]:.4f} / {earlier[1]:.4f} ms, "
                   f"ring on f32 Wh/gO (casts included) {f32_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                   f"by {bound['bound_by']}, max abs err {err:.3g}")
            if H == GAT_HEADS:
                rec[name] = dict(max_abs_err=err, ms=min(ms), plain_ms=plain_ms, **bound, library_ms=None,
                                 earlier_ms=min(earlier), f32_in_ms=f32_ms)
                msg += f", plain {plain_ms:.4f} ms (once)"
            _log(msg)
            del outs, ref
        del ops, t, m, l, gO, s1, s2, Wh
    return rec


def _plain_gat_forward(net, prep, x):
    """The GAT model's forward with its attention on the plain kernel of
    the prep's route (K6 with a hybrid plan, else K3)."""
    h = x
    for conv, relu in ((net.conv1, True), (net.conv2, False)):
        F, H = conv.out_features, conv.nheads
        Wh = torch.matmul(h, conv.weight).view(-1, H, F)
        a = conv.attention.view(-1)
        s1 = torch.einsum("nhf,hf->nh", Wh, a[: F * H].view(H, F))
        s2 = torch.einsum("nhf,hf->nh", Wh, a[F * H:].view(H, F))
        if prep.gat_plan is not None:
            h = FG.flash_gat_hybrid_forward_plain(prep.gat_plan, s1, s2, Wh)
        else:
            h = FG.flash_gat_forward_plain(prep.flash_tiles, s1, s2, Wh)
        h = h.reshape(-1, F * H)
        if relu:
            h = relu_hw(h)
    return net.head(h)


def _profile_forward(fn, label, what="1 forward"):
    """One call of ``fn`` (a forward or a training step) under
    torch.profiler: wall ms, device-busy ms (kernel intervals on the one
    stream), idle share, and the kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    _log(f"{label} profiler window ({what}): wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
         f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        _log(f"  {ms:9.4f} ms  {100 * ms / max(busy, 1e-9):5.1f}%  {name[:110]}")


def phase_gat_serve(A, x, prep, device, kern, label, cfg=SLICE):
    """GATModel answers REQUESTS forwards through ``kern``; launches, times,
    peak memory; logits against the plain-attention forward."""
    C = cfg["num_classes"]
    net = _gat_net(cfg).to(device).eval()
    x = torch.from_numpy(x).to(device)
    kernels = (K1.bsr_spmm, K2.bsr_spmm_fused, FG.flash_gat_forward, FG.flash_gat_hybrid_forward)
    with torch.no_grad():
        net(prep, x)  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        ms, per_request = [], []
        for _ in range(REQUESTS):
            before = kern.launches
            t0 = time.perf_counter()
            logits = net(prep, x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_request.append(kern.launches - before)
        launches = {k.__name__: k.launches for k in kernels}
        _all_ring(f"{label} GAT serving")
        peak = torch.cuda.max_memory_allocated()
    _log(f"{label} GAT forwards ({kern.__name__}, all on the ring kernel): " + ", ".join(f"{m:.3f}" for m in ms) + " ms")
    _log(f"launches in the {label} GAT serving run: {launches} (per request: {per_request})")
    _log(f"peak device memory in the {label} GAT serving run: {peak / 2**30:.3f} GiB")
    if per_request != [2] * REQUESTS or sum(launches.values()) != 2 * REQUESTS:
        raise AssertionError(f"{kern.__name__} launches per request {per_request}, expected 2 each "
                             f"and no other kernel: {launches}")
    with torch.no_grad():
        _profile_forward(lambda: net(prep, x), f"{label} GAT")
        ref = _plain_gat_forward(net, prep, x)
    if logits.shape != (A.n_rows, C):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    e = _check(f"{label} GAT logits vs plain-attention forward", logits, ref, GAT_TOL)
    _log(f"{label} GAT logits: max abs err {e:.3g} (|logits| max {float(ref.abs().max()):.3g})")
    return launches[kern.__name__]


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel wrapper on the training path swapped for its plain
    version where the autograd Functions call it: the reference step."""
    swaps = [(D, "bsr_spmm_fused", K2.bsr_spmm_fused_plain), (D, "bsr_spmm", K1.bsr_spmm_plain),
             (D, "spmm_plan", K9.spmm_plan_plain),
             (FG, "flash_gat_forward", FG.flash_gat_forward_plain),
             (FG, "flash_gat_hybrid_forward", FG.flash_gat_hybrid_forward_plain),
             (FG, "flash_gat_bwd_row", FG.flash_gat_bwd_row_plain),
             (FG, "flash_gat_bwd_col", FG.flash_gat_bwd_col_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _step(net, prep, x, y, mask, opt=None, seed=0):
    """One training step as train_node_classifier takes it: train mode,
    dropout from a generator seeded with ``seed``, masked cross-entropy,
    backward, and the Adam update when ``opt`` is given."""
    net.train()
    net.zero_grad(set_to_none=True)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    loss = _masked_xent(net(prep, x, generator=gen), y, mask)
    loss.backward()
    if opt is not None:
        opt.step()
    return loss


def _counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


RING_KERNELS = (K1.bsr_spmm, K2.bsr_spmm_fused, FG.flash_gat_forward, FG.flash_gat_hybrid_forward,
                FG.flash_gat_bwd_row, FG.flash_gat_bwd_col)


# each redesigned kernel's wrapper and the count of its launches on the new kernel
REDESIGNED = tuple((k, "launches_ring") for k in RING_KERNELS + (
    K2.bsr_spmm_int8_fused, K1.bsr_spmm_int8, FG.flash_gat_forward_subskip)) + (
    (K9.spmm_plan, "launches_gather"),)


def _reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for k, new in REDESIGNED + ((K2.bsr_spmm_fused_k, "launches_ring"), (K1.bsr_spmm_rowloop, "launches_cluster")):
        setattr(k, new, 0)
        k.launches_single = 0


def _all_ring(label: str) -> None:
    """Every K1-K8 and K12 launch since the last reset went through the
    ring kernel, every K9 launch through the gather kernel."""
    for k, attr in REDESIGNED:
        new = getattr(k, attr)
        if new != k.launches or k.launches_single:
            raise AssertionError(f"{label}: {k.__name__} launched {k.launches} times, {new} on the "
                                 f"redesigned kernel and {k.launches_single} on the first one")


def phase_train(data, prep, net, device, label, per_epoch, k1_view=False, cfg_kw=None, remat=None, power=None):
    """train_node_classifier for TRAIN_EPOCHS epochs on ``prep`` (the main
    path: counts reset just before, read just after, each kernel launched
    ``per_epoch[name]`` times an epoch); then timed steps, a profiler
    window over one step, optionally one step through the K1 view of the
    prep, one step's gradients against the plain-kernel step, and with
    ``remat`` = (the same model with remat=True, its launches a step) one
    remat step against the step without remat. ``power``: a
    ``PowerRecorder`` recording the training run alone."""
    x = torch.from_numpy(data.x).to(device)
    y = torch.from_numpy(data.y).to(device).long()
    mask = torch.from_numpy(data.train_mask).to(device).float()
    net = net.to(device)
    # warm-up: cuBLAS handles, the allocator, the first optimizer step of
    # the process and the evaluation's reductions (lr=0 leaves the weights)
    t0 = time.perf_counter()
    _step(net, prep, x, y, mask, torch.optim.Adam(net.parameters(), lr=0.0))
    with torch.no_grad():
        net.eval()(prep, x).argmax(dim=-1)
    torch.cuda.synchronize()
    _log(f"{label} warm-up step and evaluation: {(time.perf_counter() - t0) * 1e3:.3f} ms")
    torch.cuda.reset_peak_memory_stats()
    cfg = SGRACEConfig(num_epochs=TRAIN_EPOCHS, learning_rate=0.01, **(cfg_kw or {}))
    _reset_counts()
    t0 = time.perf_counter()
    with power.record(POWER_INTERVAL_S) if power is not None else contextlib.nullcontext():
        state, hist = train_node_classifier(net, data, cfg, seed=0, prepare=prep, device=device)
        torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    _all_ring(f"{label} training")
    if power is not None:
        # nvidia-smi's power.draw is the board's draw averaged over about a
        # second: a few samples over the epochs; J an epoch = mean W x the
        # epoch's seconds
        epoch_s = total_ms / 1e3 / TRAIN_EPOCHS
        _log(f"power over the {label} training run ({_card()}; limit {gpu_power_limit_w():.2f} W): "
             f"{len(power.frame)} samples over {power.duration_s:.3f} s, mean {power.mean_w:.2f} W; "
             f"{power.mean_w * epoch_s:.3f} J an epoch of {epoch_s * 1e3:.3f} ms")
    peak = torch.cuda.max_memory_allocated()
    _log(f"{label} train_node_classifier: {TRAIN_EPOCHS} epochs in {total_ms:.3f} ms "
         f"({total_ms / TRAIN_EPOCHS:.3f} ms an epoch: step + evaluation); loss {hist.loss}, "
         f"train acc {hist.train_acc}, test acc {hist.test_acc}")
    _log(f"launches in the {label} training run: {launches}")
    _log(f"peak device memory in the {label} training run: {peak / 2**30:.3f} GiB")
    want = {k.__name__: TRAIN_EPOCHS * per_epoch.get(k.__name__, 0) for k in KERNELS}
    if launches != want:
        raise AssertionError(f"{label} training launches {launches}, expected {want}")
    if state.step != TRAIN_EPOCHS or not all(np.isfinite(hist.loss)):
        raise AssertionError(f"{label} training: step {state.step}, losses {hist.loss}")

    opt = state.optimizer
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        _step(net, prep, x, y, mask, opt)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    _log(f"{label} training steps (forward + backward + Adam): " + ", ".join(f"{m:.3f}" for m in ms) + " ms")
    _profile_forward(lambda: _step(net, prep, x, y, mask, opt), f"{label} train", "1 training step")
    if k1_view:
        view = dataclasses.replace(prep, fused=None, fused_t=None)  # fuse=False view
        _reset_counts()
        t0 = time.perf_counter()
        _step(net, view, x, y, mask)
        torch.cuda.synchronize()
        k1_ms = (time.perf_counter() - t0) * 1e3
        k1 = _counts()
        _all_ring(f"{label} K1 view step")
        _log(f"{label} training step through the K1 view (fuse=False): {k1_ms:.3f} ms, launches {k1}")
        if k1["bsr_spmm"] != 4 or sum(k1.values()) != 4:
            raise AssertionError(f"K1 view step launches {k1}, expected bsr_spmm 4 and nothing else")
        launches["bsr_spmm"] += k1["bsr_spmm"]
        got = {k: p.grad.clone() for k, p in net.named_parameters()}
        with _plain_kernels():
            _step(net, view, x, y, mask)
        _check_grads(f"{label} K1 view", net, got)

    _step(net, prep, x, y, mask)
    got = {k: p.grad.clone() for k, p in net.named_parameters()}
    with _plain_kernels():
        _step(net, prep, x, y, mask)
    _check_grads(label, net, got)
    if remat is not None:
        _add(launches, _remat_step(label, net, remat[0].to(device), remat[1], prep, x, y, mask))
    return launches


def _remat_step(label, net, remat, want, prep, x, y, mask):
    """One training step (train mode, dropout from a generator seeded 0,
    the loop's loss, backward) of ``net`` and of ``remat``, its remat twin
    at the same weights, each after a warm-up step: the logits must be
    torch.equal, the gradients torch.equal or within REMAT_TOL of their
    largest entry; the remat step launches ``want``; step ms and the peak
    device memory of each. Returns the remat step's launches."""
    remat.load_state_dict(net.state_dict())

    def step(m):
        m.train()
        m.zero_grad(set_to_none=True)
        logits = m(prep, x, generator=torch.Generator(device=x.device).manual_seed(0))
        _masked_xent(logits, y, mask).backward()
        return logits.detach()

    res = {}
    for name, m in (("without remat", net), ("with remat", remat)):
        step(m)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        logits = step(m)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in _counts().items() if v}
        _all_ring(f"{label} step {name}")
        peak = torch.cuda.max_memory_allocated()
        res[name] = (logits, {k: p.grad.clone() for k, p in m.named_parameters()}, counts)
        _log(f"{label} training step {name}: {ms:.3f} ms, launches {counts}, peak device memory "
             f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the step's start)")
    (l0, g0, _), (l1, g1, c1) = res["without remat"], res["with remat"]
    if c1 != want:
        raise AssertionError(f"{label} remat step launches {c1}, expected {want}")
    if not torch.equal(l0, l1):
        raise AssertionError(f"{label} remat step logits differ from the step without remat")
    same = [k for k in g0 if torch.equal(g0[k], g1[k])]
    for k in g0:
        scale = float(g0[k].abs().max())
        torch.testing.assert_close(g1[k], g0[k], rtol=REMAT_TOL, atol=REMAT_TOL * scale,
                                   msg=lambda m: f"{label} remat gradient {k}: {m}")
    err = max(float((g1[k] - g0[k]).abs().max()) / max(float(g0[k].abs().max()), 1e-30) for k in g0)
    _log(f"{label} remat step: logits torch.equal to the step without remat; gradients torch.equal for "
         f"{len(same)} of {len(g0)} parameters ({same}), max err / max |grad| {err:.3g} (tolerance {REMAT_TOL})")
    return c1


def _check_grads(label, net, got):
    """``got`` against the gradients the last step left on ``net``."""
    err = 0.0
    for k, p in net.named_parameters():
        r = p.grad
        scale = float(r.abs().max())
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f"{label} gradient {k} is not finite")
        torch.testing.assert_close(got[k], r, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   msg=lambda m: f"{label} gradient {k}: {m}")
        err = max(err, float((got[k] - r).abs().max()) / max(scale, 1e-30))
    _log(f"{label} one step's gradients vs the plain-kernel step: max err / max |grad| {err:.3g}")


def phase_gat_small(device, cfg=GAT_SMALL):
    """The n=8192 graph: full-cover flash tiles, served through K3, then
    trained through K3, K4 and K5."""
    A, data, gen_s = _slice_graph(cfg)
    _log(f"small GAT graph: n={A.n_rows} nnz={A.nnz} generate {gen_s:.1f} s")
    prep = phase_gat_prepare(A, device, "small")
    if prep.gat_plan is not None:
        raise AssertionError("n=8192 must prepare full-cover flash tiles")
    launches = {"flash_gat_forward": phase_gat_serve(A, data.x, prep, device, FG.flash_gat_forward, "small", cfg)}
    per_epoch = {"flash_gat_forward": 4, "flash_gat_bwd_row": 2, "flash_gat_bwd_col": 2}
    _add(launches, phase_train(data, prep, _gat_net(cfg), device, "small GAT", per_epoch))
    return _add(launches, phase_subskip(prep.flash_tiles, A, device, "n=8192 full-cover")[1])


def _gat_net(cfg, remat=False):
    F, C = cfg["num_features"], cfg["num_classes"]
    net = GATModel(F, GAT_HIDDEN, C, nheads=GAT_HEADS, remat=remat)
    net.load_state_dict(_gat_weights(np.random.default_rng(0), F, GAT_HIDDEN, GAT_HEADS, C))
    return net


def _gcn_net(cfg, remat=False):
    F, C = cfg["num_features"], cfg["num_classes"]
    net = GCNModel(F, HIDDEN, C, remat=remat)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         _slice_weights(np.random.default_rng(0), F, HIDDEN, C).items()})
    return net


def _add(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_int8_hybrid_slice(A, device):
    """K8 at full width: the slice's graph quantized to 8 bits, the hybrid
    split (tb 256, threshold 64, K 128), Hq from a numpy seed. The main
    path is ``int8_hybrid_agg`` three times; then K8 and K7 (on the plan's
    dense part) are timed against their plain versions and must equal
    them."""
    c_a = QuantConstants(s_o=1.0, s=max(float(A.vals[: A.nnz].max()), 1e-8) / 255.0, z=0, qbits=8, signed=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = Q.prepare_int8_hybrid(A, c_a, tb=INT8_TB, rest_thresh=SLICE_SPLIT[1], K=K2.DEFAULT_K,
                                 device=device)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    B = plan.B
    _log(f"int8 hybrid prepare: {prep_s:.1f} s tb={B.tb} tiles={B.num_tiles} "
         f"({RL.nbytes(B.tiles) / 1e9:.3f} GB {B.tiles.dtype}) rest_edges={RL.live_slots(plan)} "
         f"rest_chunks={plan.num_rest_chunks} K={plan.K} steps={plan.num_steps} "
         f"segments={plan.segments.n_seg} split_runs={plan.segments.n_fin}")
    L = plan.edge_ring
    _log(f"int8 ring schedule: {L.n_tile_steps} of {B.num_tiles} tiles carry an edge "
         f"({L.n_dead_tile_steps} all -128 tiles dropped), {L.step.shape[0]} live steps, "
         f"work items {L.segments.n_seg} (split runs {L.segments.n_fin})")
    Hq = torch.from_numpy(np.random.default_rng(0).integers(-127, 127, (A.n_cols, HIDDEN)).astype(np.int8)).to(device)
    _reset_counts()
    for _ in range(REQUESTS):
        out = Q.int8_hybrid_agg(plan, Hq)
    torch.cuda.synchronize()
    launches = _counts()
    if launches["bsr_spmm_int8_fused"] != REQUESTS or sum(launches.values()) != REQUESTS:
        raise AssertionError(f"int8 hybrid aggregation launches {launches}, expected K8 x{REQUESTS} only")
    _all_ring("int8 hybrid aggregation")
    if out.shape != (A.n_rows, HIDDEN):
        raise AssertionError(f"int8 hybrid aggregation shape {tuple(out.shape)}")
    rec = {}
    err = _check_equal("K8 at slice shapes", out, K2.bsr_spmm_int8_fused_plain(plan, Hq))
    _check_equal("K8 single-stage at slice shapes", K2._bsr_spmm_int8_fused_single(plan, Hq), out)
    # the first kernel and the ring kernel in turns: single, ring, ring, single
    single = [cuda_ms(lambda: K2._bsr_spmm_int8_fused_single(plan, Hq))]
    ring = [cuda_ms(lambda: K2._bsr_spmm_int8_fused_ring(plan, Hq)) for _ in range(2)]
    single.append(cuda_ms(lambda: K2._bsr_spmm_int8_fused_single(plan, Hq)))
    n_pad = (B.n_cols + B.tb - 1) // B.tb * B.tb
    pre_ms = cuda_ms(lambda: K1._stage_hqt(Hq, n_pad, B.n_cols))
    ms = float(np.median(ring))
    plain_ms = cuda_ms(lambda: K2.bsr_spmm_int8_fused_plain(plan, Hq), reps=5)
    bound = _agg_bound(B, Hq, out, "int8", plan=plan, ring=L)
    all_tiles = _agg_bound(B, Hq, out, "int8", plan=plan)
    rec["bsr_spmm_int8_fused"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound, library_ms=None)
    _log(f"bsr_spmm_int8_fused at slice shapes [n={A.n_rows}, P={HIDDEN}]: int8 ring kernel "
         + " / ".join(f"{m:.4f}" for m in ring) + f" ms ({A.nnz / (ms * 1e-3) / 1e6:.1f} M edges/s; "
         f"of which the transposed-Hq pre-pass {pre_ms:.4f} ms), single-stage kernel "
         + " / ".join(f"{m:.4f}" for m in single) + f" ms (same run, in turns), plain {plain_ms:.4f} ms "
         f"(median of 5), bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} on the tiles that carry "
         f"an edge [all {B.num_tiles} tiles: {all_tiles['bound_ms']:.4f} ms]; both kernels equal to the "
         f"plain version")
    out7 = K1.bsr_spmm_int8(B, Hq)
    _check_equal("K7 on the hybrid plan's dense part", out7, K1.bsr_spmm_int8_plain(B, Hq))
    ms7 = cuda_ms(lambda: K1.bsr_spmm_int8(B, Hq))
    plain7 = cuda_ms(lambda: K1.bsr_spmm_int8_plain(B, Hq), reps=5)
    b7 = _agg_bound(B, Hq, out7, "int8")
    _log(f"bsr_spmm_int8 on the same dense part [T={B.num_tiles}, P={HIDDEN}]: int8 ring kernel {ms7:.4f} ms, "
         f"plain {plain7:.4f} ms (median of 5), bound {b7['bound_ms']:.4f} ms by {b7['bound_by']}, equal")
    _log(f"peak device memory in the int8 hybrid phase: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return rec, launches


def _banded_graph(n, extra, seed):
    """Sym-normalised banded + random graph (bands +-1 and +-2, ``extra``
    random edges): bounded degrees, the shape the int8 accuracy limit is
    defined on."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for d in (-2, -1, 1, 2):
        i = np.arange(max(0, -d), min(n, n - d))
        rows.append(i)
        cols.append(i + d)
    rows.append(rng.integers(0, n, extra))
    cols.append(rng.integers(0, n, extra))
    k = np.unique(np.concatenate(rows).astype(np.int64) * n + np.concatenate(cols))
    return sym_norm(np.stack([k // n, k % n]), n)


def _int8_gcn_serve(A, label, device, cfg, rel_limit, tb=INT8_TB):
    """Freeze the 100 -> 128 -> 16 net on ``A`` (weights uniform +-0.5 and
    features uniform [0, 1] from a numpy seed, a_max from the adjacency,
    activation ranges from one float forward on the host) at tile height
    ``tb`` (None: freeze_gcn2_sparse's default), answer REQUESTS requests
    through K7 (both launches of each on the ring kernel), hold the output
    against the same forward on the plain K7 (equal) and the float forward
    (``rel_limit`` of its largest output, where given). Returns (net,
    launches)."""
    n, F, C = A.n_rows, cfg["num_features"], cfg["num_classes"]
    tb_kw = {} if tb is None else dict(tb=tb)
    tb = 512 if tb is None else tb
    T = len(K1.bsr_tile_keys(A, tb, cover_rows=True))
    _log(f"int8 GCN {label}: n={n} nnz={A.nnz}; full cover at tb={tb}{'' if tb_kw else ' (the default)'}: "
         f"{T} tiles, {T * tb * tb / 1e9:.3f} GB int8")
    rng = np.random.default_rng(0)
    W1 = rng.uniform(-0.5, 0.5, (F, HIDDEN)).astype(np.float32)
    W2 = rng.uniform(-0.5, 0.5, (HIDDEN, C)).astype(np.float32)
    X = rng.uniform(0.0, 1.0, (n, F)).astype(np.float32)
    a_max = float(A.vals[: A.nnz].max()) or 1.0
    cal = CalibrationTable.for_qbits(8, dict(w_min=-0.5, w_max=0.5, w_min2=-0.5, w_max2=0.5,
                                             f_min=0.0, f_max=1.0, a_min=0.0, a_max=a_max))
    amax = Q.collect_amax_gcn2_sparse(A, X, W1, W2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = Q.freeze_gcn2_sparse(W1, W2, A, cal, device=device, **tb_kw, **amax)
    torch.cuda.synchronize()
    if net.a_bsr.tb != tb:
        raise AssertionError(f"freeze_gcn2_sparse built tb={net.a_bsr.tb}, expected {tb}")
    L = net.a_bsr.edge_ring  # built here, with the tiles (the first ring launch would build it)
    _log(f"freeze_gcn2_sparse ({label}): {time.perf_counter() - t0:.1f} s tiles={net.a_bsr.num_tiles} "
         f"segments={net.a_bsr.segments.n_seg} split_runs={net.a_bsr.segments.n_fin} amax={amax}; "
         f"ring K7 schedule: {L.n_tile_steps} row pieces of {K1.k7_row_piece(tb)} carry an edge "
         f"({L.n_dead_tile_steps} all -128 dropped), work items {L.segments.n_seg} "
         f"(split runs {L.segments.n_fin})")
    xs = Q.quantize_unsigned_shifted(torch.from_numpy(X).to(device), cal.features)
    Q.int8_gcn2_sparse_forward(net, xs)  # warm-up: cuBLASLt handles, allocator
    torch.cuda.synchronize()
    _reset_counts()
    ms, per_request = [], []
    for _ in range(REQUESTS):
        before = _counts()["bsr_spmm_int8"]
        t0 = time.perf_counter()
        out = Q.int8_gcn2_sparse_forward(net, xs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per_request.append(_counts()["bsr_spmm_int8"] - before)
    launches = _counts()
    _log(f"int8 GCN requests ({label}, K7 route): " + ", ".join(f"{m:.3f}" for m in ms) + " ms")
    _log(f"launches in the int8 GCN serving run ({label}): {launches} (K7 per request: {per_request})")
    if per_request != [2] * REQUESTS or sum(launches.values()) != 2 * REQUESTS:
        raise AssertionError(f"K7 launches per request {per_request}, expected 2 each and no other kernel")
    _all_ring(f"int8 GCN serving ({label})")
    if out.shape != (n, C) or not torch.isfinite(out).all():
        raise AssertionError(f"int8 GCN output shape {tuple(out.shape)} or non-finite")
    kern = Q.bsr_spmm_int8
    Q.bsr_spmm_int8 = K1.bsr_spmm_int8_plain
    try:
        ref = Q.int8_gcn2_sparse_forward(net, xs)
    finally:
        Q.bsr_spmm_int8 = kern
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("int8 GCN output differs from the same forward on the plain K7")
    mat = A.to_scipy()
    flt = mat @ (np.maximum(mat @ (X @ W1), 0.0) @ W2)
    rel = float(np.abs(out.cpu().numpy() - flt).max() / (np.abs(flt).max() + 1e-9))
    _log(f"int8 GCN output ({label}): equal to the plain-K7 forward; relative error against the float forward "
         f"{rel:.4f}" + (f" (limit {rel_limit})" if rel_limit else " (reported, no limit: see the docstring)"))
    if rel_limit and rel >= rel_limit:
        raise AssertionError(f"int8 GCN relative error {rel} against the float forward")
    return net, launches


def _k7_bound(B, Hq, out) -> dict:
    """Bound of K7 on the row pieces that carry an edge
    (``utils/roofline.cost_k7``)."""
    return RL.cost_k7(B, Hq.shape[1], RL.nbytes(Hq, out)).bound()


def _k7_times(B, label, rng, device, Ps) -> dict:
    """K7 at ``B``'s shapes for each P: the ring kernel and the single-stage
    kernel in turns (single, ring, ring, single), both equal to the plain
    version; the bound on the pieces that carry an edge. Returns the record
    at the first P."""
    rec = None
    for P in Ps:
        Hq = torch.from_numpy(rng.integers(-127, 128, (B.n_cols, P)).astype(np.int8)).to(device)
        o = K1._bsr_spmm_int8_ring(B, Hq)
        err = _check_equal(f"K7 ring {label} P={P}", o, K1.bsr_spmm_int8_plain(B, Hq))
        _check_equal(f"K7 single-stage {label} P={P}", K1._bsr_spmm_int8_single(B, Hq), o)
        single = [cuda_ms(lambda: K1._bsr_spmm_int8_single(B, Hq))]
        ring = [cuda_ms(lambda: K1._bsr_spmm_int8_ring(B, Hq)) for _ in range(2)]
        single.append(cuda_ms(lambda: K1._bsr_spmm_int8_single(B, Hq)))
        n_pad = (B.n_cols + B.tb - 1) // B.tb * B.tb
        pre_ms = cuda_ms(lambda: K1._stage_hqt(Hq, n_pad, B.n_cols))
        p_ms = cuda_ms(lambda: K1.bsr_spmm_int8_plain(B, Hq), reps=3)
        bound = _k7_bound(B, Hq, o)
        all_tiles = _agg_bound(B, Hq, o, "int8")
        ms = float(np.median(ring))
        _log(f"bsr_spmm_int8 {label} [n={B.n_rows}, tb={B.tb}, T={B.num_tiles}, P={P}]: int8 ring kernel "
             + " / ".join(f"{m:.4f}" for m in ring) + f" ms (of which the transposed-Hq pre-pass {pre_ms:.4f}), "
             "single-stage kernel " + " / ".join(f"{m:.4f}" for m in single) + f" ms (same run, in turns), "
             f"plain {p_ms:.4f} ms (median of 3), bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} on the "
             f"{B.edge_ring.n_tile_steps} row pieces that carry an edge [all {B.num_tiles} tiles: "
             f"{all_tiles['bound_ms']:.4f} ms]; both equal to the plain version")
        if rec is None:
            rec = dict(max_abs_err=err, ms=ms, plain_ms=p_ms, **bound, library_ms=None,
                       earlier_ms=float(np.median(single)))
    return rec


def phase_int8_gcn(device, cfg=INT8_GCN):
    """Full-integer GCN serving (100 -> 128 -> 16) on a full int8 tile
    cover: ``freeze_gcn2_sparse`` -> ``int8_gcn2_sparse_forward``, K7 twice
    a request on the ring kernel. The full cover is what limits the size: at
    most (n / tb)^2 tiles of tb^2 bytes.

    Two graphs of n nodes go through the same entry points. The slice's
    power-law generator is the main path (launch counts, equality with the
    plain-K7 forward, K7's times at its shapes), served at tb 256 and at
    ``freeze_gcn2_sparse``'s default tb 512; its error against the float
    forward is printed without a limit, because one 8-bit grid per tensor
    cannot hold a hub row's range (the hub's layer-1 output sets
    ``x2_absmax`` some 60 times above an ordinary node's, whose values then
    round to a few levels; the reference's int8 design has the same
    limit). The accuracy limit of 0.08 is held on the bounded-degree banded
    graph on which the reference defines it."""
    A, _, gen_s = _slice_graph(cfg)
    n, C = A.n_rows, cfg["num_classes"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    net, launches = _int8_gcn_serve(A, "power-law", device, cfg, None)
    # K7 at the path's layer-1 shape (P = 128), and its layer-2 shape beside it
    rng = np.random.default_rng(1)
    rec = {"bsr_spmm_int8": _k7_times(net.a_bsr, "at the int8 GCN's shapes", rng, device, (HIDDEN, C))}
    del net
    torch.cuda.empty_cache()
    net, more = _int8_gcn_serve(A, "power-law, default tb", device, cfg, None, tb=None)
    launches = _add(launches, more)
    _k7_times(net.a_bsr, "at the int8 GCN's shapes, tb 512", rng, device, (HIDDEN, C))
    del net
    torch.cuda.empty_cache()
    _, more = _int8_gcn_serve(_banded_graph(n, n // 4, 0), "banded", device, cfg, INT8_REL_TOL)
    _log(f"peak device memory in the int8 GCN phase: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return rec, _add(launches, more)


def phase_int8_gat(device, cfg=GAT_SMALL):
    """One int8 GAT layer (100 -> 64, one head) on K3 over full-cover mask
    tiles at n=8192, against the same layer on the edge list."""
    A, _, _ = _slice_graph(cfg)
    n, F = A.n_rows, cfg["num_features"]
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 1.0, (n, F)).astype(np.float32)
    W = rng.uniform(-0.5, 0.5, (F, GAT_HIDDEN)).astype(np.float32)
    att = rng.uniform(-0.5, 0.5, (2 * GAT_HIDDEN, 1)).astype(np.float32)
    c_x = QuantConstants(s_o=1.0, s=1.0 / 255.0, z=0, qbits=8, signed=False)
    c_w = QuantConstants(s_o=1.0, s=0.5 / 127.0, z=0, qbits=8, signed=True)
    layer = Q.freeze_gat_layer(W, att, c_x, c_w, h_absmax=float(np.abs(X @ W).max()), device=device)
    xs = Q.quantize_unsigned_shifted(torch.from_numpy(X).to(device), c_x)
    B = K1.bsr_mask_from_sparse(A, tb=256, device=device)
    Ad = A.to(device)
    Q.int8_gat_layer_flash(layer, B, xs)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    acc_f, sc_f = Q.int8_gat_layer_flash(layer, B, xs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    if launches["flash_gat_forward"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"int8 GAT layer launches {launches}, expected K3 once")
    if acc_f.shape != (n, GAT_HIDDEN) or not torch.isfinite(acc_f).all():
        raise AssertionError(f"int8 GAT layer on K3: shape {tuple(acc_f.shape)} or non-finite")
    kern = Q.flash_gat_forward
    Q.flash_gat_forward = FG.flash_gat_forward_plain
    try:
        ref = Q.int8_gat_layer_flash(layer, B, xs)[0]
    finally:
        Q.flash_gat_forward = kern
    # h_q reaches +-127, so bf16(p) is held relative to the largest output
    err = float((acc_f - ref).abs().max())
    if err > GAT_TOL * float(ref.abs().max()):
        raise AssertionError(f"int8 GAT layer on K3 differs from the plain K3 by {err}")
    # the edge-list layer rounds each attention weight to the 255 grid, which
    # cannot resolve a hub row's weights (1/degree < 1/510 rounds to 0): it is
    # the yardstick on the rows whose degree the grid resolves
    acc_e, sc_e = Q.int8_gat_layer(layer, Ad.rows, Ad.cols, Ad.vals > 0, n, xs)
    deg = torch.zeros(n, device=device).index_add_(0, Ad.rows.long(), (Ad.vals > 0).float())
    rows = deg <= INT8_GAT_MAX_DEGREE
    out_f = acc_f.double()[rows] * sc_f
    out_e = acc_e.double()[rows] * sc_e
    rel = float((out_f - out_e).abs().max() / (out_e.abs().max() + 1e-9))
    _log(f"int8 GAT layer on K3 [n={n}, {F} -> {GAT_HIDDEN}, T={B.num_tiles}]: {ms:.3f} ms, launches {launches}; "
         f"max abs err {err:.3g} against the plain K3; against the edge-list int8 layer {rel:.4f} of its largest "
         f"output on the {int(rows.sum())} rows of degree <= {INT8_GAT_MAX_DEGREE} (limit {INT8_GAT_TOL})")
    if rel >= INT8_GAT_TOL:
        raise AssertionError(f"int8 GAT layer on K3: relative error {rel} against the edge-list layer")
    return launches


def phase_fake_quant(A, data, device, cfg=SLICE):
    """Fake-quant (QAT) GCN at 2^20, width 128: calibrate from one float
    forward, the 8-bit model on a value-tile prep (the hybrid split
    SLICE_SPLIT without rank-1 masks, as ``prepare_from_config`` keeps for
    ``fake_quantization``), one forward against the same forward on
    the plain K1, then three training epochs (K1, the ring kernel, on
    ``bsr`` and ``bsr_t``). ``map_adjacency_vals`` remaps a tile set when
    it is first read: a forward rewrites ``bsr`` and the remainder, the
    backward ``bsr_t``; the cost of both is timed beside the forward."""
    qcfg = SGRACEConfig(fake_quantization=True, num_epochs=TRAIN_EPOCHS, learning_rate=0.01)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prep = prepare_adjacency(A, method="hybrid", tb=SLICE_SPLIT[0], rest_thresh=SLICE_SPLIT[1], rank1=False,
                             device=device)
    torch.cuda.synchronize()
    _log(f"fake-quant prepare (value tiles, no rank-1 masks): {time.perf_counter() - t0:.1f} s kind={prep.kind} "
         f"tiles={prep.bsr.num_tiles} form={prep.bsr.tiles.dtype}{list(prep.bsr.tiles.shape[1:])} "
         f"({RL.nbytes(prep.bsr.tiles) / 1e9:.3f} GB a direction) rest_edges={prep.rest.nnz}")
    if prep.r1_row is not None or prep.bsr.tiles.dtype != torch.bfloat16:
        raise AssertionError("a fake_quantization prep must hold value tiles")
    x = torch.from_numpy(data.x).to(device)
    flt = _gcn_net(cfg).to(device).eval()
    t0 = time.perf_counter()
    cal = calibrate(flt, prep, x, qbits=8)
    torch.cuda.synchronize()
    _log(f"calibrate (one float forward with telemetry): {(time.perf_counter() - t0) * 1e3:.1f} ms "
         f"f_max={cal.raw['f_max']:.4g} f_max2={cal.raw['f_max2']:.4g} "
         f"w_max={cal.raw['w_max']:.4g} w_max2={cal.raw['w_max2']:.4g}")
    net = GCNModel(cfg["num_features"], HIDDEN, cfg["num_classes"], calibration=cal)
    net.load_state_dict(flt.state_dict())
    net = net.to(device).eval()
    with torch.no_grad():
        net(prep, x)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        ms = []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            logits = net(prep, x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = _counts()
        if launches["bsr_spmm"] != 2 * REQUESTS or sum(launches.values()) != 2 * REQUESTS:
            raise AssertionError(f"fake-quant forward launches {launches}, expected K1 x2 a forward only")
        _all_ring("fake-quant forward")
        _profile_forward(lambda: net(prep, x), "fake-quant GCN")
        # the adjacency quantizer of one layer call: what a forward reads
        # (bsr, the remainder) and every representation (bsr_t and the edge
        # values too, which an eager remap rewrote on every call)
        q = net.conv1.quant
        fq = lambda v: fake_quant_unsigned(v, q.adjacency, q.w_qbits)

        def remap(names):
            m = D.map_adjacency_vals(prep, fq)
            for name in names:
                getattr(m, name)

        read_ms = cuda_ms(lambda: remap(("bsr", "rest")), reps=5)
        all_ms = cuda_ms(lambda: remap(("bsr", "rest", "bsr_t", "A")), reps=5)
        with _plain_kernels():
            ref = net(prep, x)
    _log("fake-quant GCN forwards (K1 on remapped value tiles): " + ", ".join(f"{m:.3f}" for m in ms) + " ms")
    fwd = float(np.median(ms))
    _log(f"map_adjacency_vals a layer call: {read_ms:.3f} ms for what a forward reads (bsr, remainder), "
         f"{all_ms:.3f} ms for every representation; two layers: {2 * read_ms:.3f} ms of the {fwd:.3f} ms "
         f"forward ({2 * read_ms / fwd:.2f}); remapping everything would add {2 * (all_ms - read_ms):.3f} ms "
         f"({2 * all_ms:.3f} of {fwd + 2 * (all_ms - read_ms):.3f} ms, {2 * all_ms / (fwd + 2 * (all_ms - read_ms)):.2f})")
    scale = float(ref.abs().max())
    torch.cuda.synchronize()
    if logits.shape != (A.n_rows, cfg["num_classes"]) or not torch.isfinite(logits).all():
        raise AssertionError(f"fake-quant logits shape {tuple(logits.shape)} or non-finite")
    err = float((logits - ref).abs().max())
    _log(f"fake-quant logits against the plain-K1 forward: max abs err {err:.3g} of |logits| max {scale:.3g}")
    if err > QAT_TOL * scale:
        raise AssertionError(f"fake-quant logits differ from the plain-K1 forward by {err} (max {scale})")
    net.train()
    _reset_counts()
    t0 = time.perf_counter()
    state, hist = train_node_classifier(net, data, qcfg, seed=0, prepare=prep, device=device)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    train_launches = _counts()
    _all_ring("fake-quant training")
    _log(f"fake-quant train_node_classifier: {TRAIN_EPOCHS} epochs in {total_ms:.3f} ms "
         f"({total_ms / TRAIN_EPOCHS:.3f} ms an epoch: step + evaluation); loss {hist.loss}, "
         f"train acc {hist.train_acc}, test acc {hist.test_acc}")
    _log(f"launches in the fake-quant training run: {train_launches}")
    # a step: K1 on bsr twice forward, on bsr_t twice backward; an evaluation: K1 twice
    if train_launches["bsr_spmm"] != 6 * TRAIN_EPOCHS or sum(train_launches.values()) != 6 * TRAIN_EPOCHS:
        raise AssertionError(f"fake-quant training launches {train_launches}, expected K1 x{6 * TRAIN_EPOCHS} only")
    if state.step != TRAIN_EPOCHS or not all(np.isfinite(hist.loss)):
        raise AssertionError(f"fake-quant training: step {state.step}, losses {hist.loss}")
    _log(f"peak device memory in the fake-quant phase: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return _add(launches, train_launches)


def _empty_graph(n):
    z = np.zeros(0, np.int64)
    return SparseMatrix.from_coo(z, z, np.zeros(0, np.float32), (n, n))


def _hub_band_graph(n_blocks, tb, hub, seed):
    """Mask-valued edges: a band near the diagonal (one or two tiles a row
    block) and, with ``hub``, rows of row block 0 linked to every column
    block; row and column block 3 hold no edge."""
    rng = np.random.default_rng(seed)
    n = n_blocks * tb
    r = np.arange(n).repeat(3)
    ei = [np.stack([r, (r + rng.integers(-4, 5, r.shape[0])) % n])]
    if hub:
        ei.append(np.stack([rng.integers(0, tb // 2, 4 * n_blocks),
                            np.arange(4 * n_blocks) // 4 * tb + rng.integers(0, tb, 4 * n_blocks)]))
    ei = np.unique(np.concatenate(ei, axis=1), axis=1)
    ei = ei[:, (ei // tb != 3).all(axis=0)]
    return SparseMatrix.from_coo(ei[0], ei[1], np.ones(ei.shape[1], np.float32), (n, n))


def phase_variant_kernels_small(device):
    """K9, K10, K11 and K12 against their plain versions over their forms."""
    gen = torch.Generator(device=device).manual_seed(5)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=device)

    # ---- K9: name, graph, rb = cb, be, P, H dtype
    k9_cases = [
        ("rank1-128-P16", _random_graph(3001, False, 100), 128, 1024, 16, torch.float32),
        ("weighted-256-be2048-P100", _random_graph(3001, True, 101), 256, 2048, 100, torch.float32),
        ("rank1-1024-P128", _random_graph(5000, False, 102), 1024, 1024, 128, torch.float32),
        ("weighted-128-be2048-P128-bf16H", _random_graph(2500, True, 103), 128, 2048, 128, torch.bfloat16),
        ("weighted-256-P33-unaligned", _random_graph(2100, True, 104), 256, 1024, 33, torch.float32),
        ("empty-row-block-256-P100", _int8_graph(2600, 105, empty_rb=2, tb=256), 256, 1024, 100, torch.float32),
        ("empty-matrix-128-P16", _empty_graph(300), 128, 1024, 16, torch.float32),
    ]
    split = False
    for name, A, blk, be, P, hdt in k9_cases:
        n = A.n_rows
        prep = prepare_adjacency(A, method="pallas", rb=blk, cb=blk, be=be, device=device)
        plan, plan_t = prep.plan, prep.plan_t
        split |= plan.segments.n_fin > 0
        H = randn(n + 37, P).to(hdt)  # spare rows of H are never read
        out = K9.spmm_plan(plan, H)  # the kernel its shape selects
        err = _check(f"K9 {name}", out, K9.spmm_plan_plain(plan, H), K9_TOL)
        gather = K9.gather_shape_ok(P, H.data_ptr())
        if gather:  # the first kernel on the same operands
            _check(f"K9 {name} first kernel", K9._spmm_plan_single(plan, H), out, K9_TOL)
        if "empty" in name:
            rows = slice(2 * blk, 3 * blk) if "block" in name else slice(None)
            if (out[rows] != 0).any():
                raise AssertionError(f"K9 {name}: rows without an edge must come out exactly 0")
        g = randn(n, P).to(hdt)
        err_t = _check(f"K9 {name} on plan_t", K9.spmm_plan(plan_t, g), K9.spmm_plan_plain(plan_t, g), K9_TOL)
        vals = torch.rand(A.vals.shape[0], generator=gen, device=device) + 0.1
        pv = K9.plan_with_vals(plan, vals)
        err_v = _check(f"K9 {name} plan_with_vals", K9.spmm_plan(pv, H), K9.spmm_plan_plain(pv, H), K9_TOL)
        live = int((plan.perm >= 0).sum())
        _log(f"  K9 {name} ({'gather kernel and first kernel' if gather else 'first kernel'}): "
             f"n={n} nnz={A.nnz} groups={plan.num_groups} be={plan.be} "
             f"fill={live / max(plan.perm.numel(), 1):.3f} row segments={plan.segments.n_seg} "
             f"split_rows={plan.segments.n_fin} err {err:.3g} plan_t {err_t:.3g} with_vals {err_v:.3g}")
    if not split:
        raise AssertionError("no K9 case split a hub row (finalize pass)")

    # ---- K10: the tile forms, a row block without a tile in the value form
    k10_cases = [
        ("bf16-values-empty-rb", _int8_graph(2600, 110, empty_rb=2, tb=128),
         lambda A: K1.bsr_from_sparse(A, tb=128, device=device), 100, torch.float32),
        ("f32-values-tb256", _random_graph(2100, True, 111),
         lambda A: K1.bsr_from_sparse(A, tb=256, dtype=torch.float32, device=device), 128, torch.bfloat16),
        ("int8-mask-tb256", _random_graph(3001, False, 112),
         lambda A: K1.bsr_mask_from_sparse(A, tb=256, device=device), 40, torch.float32),
        ("packed-tb1024", _random_graph(5000, False, 113),
         lambda A: K1.bsr_bitmask_from_sparse(A, tb=1024, device=device), 72, torch.float32),
        ("packed-tb128-P33", _random_graph(1500, False, 114),
         lambda A: K1.bsr_bitmask_from_sparse(A, tb=128, device=device), 33, torch.float32),
    ]
    for name, A, build, P, hdt in k10_cases:
        B = build(A)
        H = randn(A.n_cols, P).to(hdt)
        out = K1.bsr_spmm_rowloop(B, H)  # the kernel its shape selects
        err = _check(f"K10 {name}", out, K1.bsr_spmm_rowloop_plain(B, H), K1_TOL)
        err1 = _check(f"K10 {name} against K1", out, K1.bsr_spmm(B, H), K1_TOL)
        cluster = K1.ring_shape_ok(K1._tile_mode(B.tiles, B.tb), B.tb, P)
        if cluster:  # the single-stage kernel on the same operands
            _check(f"K10 {name} single-stage", K1._bsr_spmm_rowloop_single(B, H), out, K1_TOL)
        if "empty" in name:
            if 2 in B.tile_rb.tolist() or (out[256:384] != 0).any():
                raise AssertionError("K10: the empty row block must come out exactly 0")
        longest = int(torch.bincount(B.tile_rb.long()).max())
        _log(f"  K10 {name}: T={B.num_tiles} tiles {tuple(B.tiles.shape[1:])} {B.tiles.dtype} "
             f"longest run={longest} {'cluster kernel (and single-stage)' if cluster else 'single-stage'} "
             f"err {err:.3g} against K1 {err1:.3g}")
    # the cluster kernel: a hub row block of hundreds of live tiles split over
    # a cluster, and an all-light band; clusters of 8 and 16
    for name, tb, hub, mask, P, hdt in (("hub-int8-tb256", 256, True, True, 128, torch.float32),
                                        ("hub-bf16-tb128-P200", 128, True, False, 200, torch.bfloat16),
                                        ("band-int8-tb64", 64, False, True, 64, torch.float32)):
        A = _hub_band_graph(200, tb, hub, 115)
        B = K1.bsr_from_sparse(A, tb=tb, mask=mask, cover_rows=True, cover_cols=True, device=device)
        H = randn(A.n_cols, P).to(hdt)
        ref1, ref = K1.bsr_spmm(B, H), K1.bsr_spmm_rowloop_plain(B, H)
        for C in K1.ROWLOOP_CLUSTERS:
            sched = _cluster_sched(B, C)
            out = K1._bsr_spmm_rowloop_cluster(B, H, C)
            err = _check(f"cluster K10 {name} C={C}", out, K1.bsr_spmm_rowloop_cluster_plain(B, H, sched), K1_TOL)
            _check(f"cluster K10 {name} C={C} against the plain K10", out, ref, K1_TOL)
            err1 = _check(f"cluster K10 {name} C={C} against K1", out, ref1, K1_TOL)
            if (sched.n_heavy > 0) != hub or out[3 * tb: 4 * tb].any():
                raise AssertionError(f"cluster K10 {name}: {sched.n_heavy} heavy items, or the empty row block is not 0")
            _log(f"  cluster K10 {name} C={C}: live tiles {B.ring.n_tile_steps} of {B.num_tiles}, "
                 f"items {sched.n_items} ({sched.n_heavy} heavy, over {sched.heavy_min} live tiles), "
                 f"err {err:.3g} against K1 {err1:.3g}")

    # ---- K11: k 2 and 4, both attach modes, rank-1 scalings and value mode;
    # P = 100 takes the single-stage kernel, P = 128 the ring kernel where
    # fused_k_ring_shape_ok holds (equal to K2's ring at k = 2)
    for weighted in (False, True):
        A = _random_graph(2600, weighted, 120 + weighted)
        prep = prepare_adjacency(A, method="hybrid", tb=128, rest_thresh=24, build_transpose=False,
                                 device=device)
        r1 = {} if weighted else dict(r1_row=prep.r1_row.cpu().numpy(), r1_col=prep.r1_col.cpu().numpy())
        for attach in (True, False):
            base = K2.build_fused_plan(prep.bsr, prep.rest, attach_chunks=attach, **r1)
            for P in (100, 128):
                H = randn(2600, P)
                ref2 = K2.bsr_spmm_fused(base, H)
                for k in (2, 4):
                    plan = K2.build_fused_plan(prep.bsr, prep.rest, attach_chunks=attach, k_steps=k, **r1)
                    ring = K2.fused_k_ring_shape_ok(K1._tile_mode(plan.B.tiles, 128), 128, P, plan.K, k)
                    out = K2.bsr_spmm_fused_k(plan, H)
                    err = _check(f"K11 k={k}", out, K2.bsr_spmm_fused_k_plain(plan, H), K2_TOL)
                    err2 = _check(f"K11 k={k} against K2 on the unpadded plan", out, ref2, K2_TOL)
                    equal = bool(torch.equal(out, ref2))
                    if ring and k == 2 and not equal:
                        raise AssertionError(f"the ring K11 at k=2 differs from K2's ring (P={P}, attach={attach})")
                    if ring:
                        _check(f"K11 k={k} single-stage", K2._bsr_spmm_fused_k_single(plan, H), out, K2_TOL)
                    _log(f"  K11 {'values' if weighted else 'rank-1'} attach={attach} P={P} k={k}: "
                         f"{'ring' if ring else 'single-stage'} kernel, steps {base.num_steps} -> {plan.num_steps} "
                         f"(live {plan.ring.step.shape[0]}) kinds={sorted(set(plan.step_kind.tolist()))} "
                         f"err {err:.3g} against K2 {err2:.3g}{', equal to K2' if equal else ''}")

    # ---- K12: int8 and value tiles, isolated rows, sb 8 to 256, F 64 (the
    # ring kernel) and 40 (the single-stage one)
    for name, weighted, kw, F in (("int8-tb256", False, dict(method="xla"), 64),
                                  ("int8-tb256", False, dict(method="xla"), 40),
                                  ("bf16-values-tb256", True, dict(method="bsr", rank1=False, tb=256), 64)):
        A = _random_graph(3001, weighted, 130 + weighted, isolated=7)
        prep = prepare_adjacency(A, for_gat=True, build_transpose=False, device=device, **kw)
        B = prep.flash_tiles
        s1, s2, Wh = (x[:, 0] for x in _scores(3001, 1, F, gen, device))
        ring = FG._takes_ring(B, Wh)
        k3 = FG.flash_gat_forward(B, s1, s2, Wh)  # K3 on the route K12 takes
        has = torch.zeros(3001, dtype=torch.bool, device=device)
        has[prep.A.rows[: A.nnz][prep.A.vals[: A.nnz] > 0].long()] = True
        for sb in (8, 16, 32, 64, 128, 256):
            pop = FG.subblock_pop_bitmap(B, A, sb)
            before = FG.flash_gat_forward_subskip.launches_ring
            out = FG.flash_gat_forward_subskip(B, pop, s1, s2, Wh, sb=sb)
            if (FG.flash_gat_forward_subskip.launches_ring > before) != ring:
                raise AssertionError(f"K12 {name} F={F} sb={sb} took the wrong route")
            ref = FG.flash_gat_forward_subskip_plain(B, pop, s1, s2, Wh, sb=sb)
            err = _check(f"K12 {name} F={F} sb={sb}", out, ref, GAT_TOL)
            if ring:
                _check(f"K12 {name} F={F} sb={sb} single-stage",
                       FG._flash_gat_forward_subskip_single(B, pop, s1, s2, Wh, sb=sb), ref, GAT_TOL)
            # what K12 skips adds exact zeros in K3 on the same route, in the same order
            if not torch.equal(out, k3):
                raise AssertionError(f"K12 {name} F={F} sb={sb} differs from K3 on the same tiles and route")
            if has.all() or (out[~has] != 0).any():
                raise AssertionError(f"K12 {name}: rows without an edge must come out exactly 0")
            # a bitmap that clears populated sub-blocks: their edges are never seen
            cut = pop & np.random.default_rng(sb).integers(-2**31, 2**31, pop.shape, dtype=np.int64).astype(np.int32)
            err_cut = _check(f"K12 {name} F={F} sb={sb} cleared bitmap",
                             FG.flash_gat_forward_subskip(B, cut, s1, s2, Wh, sb=sb),
                             FG.flash_gat_forward_subskip_plain(B, cut, s1, s2, Wh, sb=sb), GAT_TOL)
            bits = RL.pop_bits(pop)
            _log(f"  K12 {name} F={F} sb={sb}: {'ring (and single-stage)' if ring else 'single-stage'} "
                 f"T={B.num_tiles} populated sub-blocks {bits} of {B.num_tiles * (B.tb // sb) ** 2} err {err:.3g} "
                 f"(cleared bitmap, {RL.pop_bits(cut)} set: {err_cut:.3g}), equal to K3 on the same route")


def _k9_bound(plan, H, out) -> dict:
    """Bound of K9 (``utils/roofline.cost_pallas``); also the bytes and
    operations counted."""
    c = RL.cost_pallas(plan, H.shape[1], RL.nbytes(H, out))
    return dict(c.bound(), nbytes=c.bytes, ops=c.total_flops)


def _plan_bytes_k9(plan) -> int:
    return RL.nbytes(plan.lrow, plan.lcol, plan.val, plan.perm)


def phase_pallas_slice(A, data, device, k2_logits, cfg=SLICE):
    """The pallas kind at full width: prepare_from_config, K9 timed, the
    GCN served and trained through K9, agg_matmul_with_vals, and K9 at the
    config's default tiling."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prep = prepare_from_config(A, SGRACEConfig(**PALLAS_CFG), device=device)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    plan, plan_t = prep.plan, prep.plan_t
    if prep.kind != "pallas" or plan is None or plan_t is None:
        raise AssertionError(f"use_pallas must prepare the pallas kind, got {prep.kind}")
    _log(f"pallas prepare (plan and plan_t): {prep_s:.1f} s rb={plan.rb} cb={plan.cb} be={plan.be} "
         f"groups={plan.num_groups} fill={plan.nnz / plan.perm.numel():.3f} "
         f"plan bytes {_plan_bytes_k9(plan) / 1e9:.3f} GB a direction; row segments={plan.segments.n_seg} "
         f"split_rows={plan.segments.n_fin} partials={plan.segments.n_part}; "
         f"plan_t: groups={plan_t.num_groups} split_rows={plan_t.segments.n_fin}")
    # the kind builds plan_t whatever build_transpose says (as the JAX
    # package): what that adds to a prep made for serving only
    t0 = time.perf_counter()
    serve = prepare_adjacency(A, method="pallas", build_transpose=False, device=device)
    torch.cuda.synchronize()
    both_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd_only = K9.plan_spmm(A, rb=1024, cb=1024, be=1024, device=device)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    if serve.plan_t is None:
        raise AssertionError("the pallas kind must build plan_t with build_transpose=False too")
    _log(f"pallas prepare with build_transpose=False: {both_s:.1f} s, of which the forward plan alone {fwd_s:.1f} s; "
         f"plan_t adds {_plan_bytes_k9(serve.plan_t) / 1e9:.3f} GB of device memory")
    del serve, fwd_only

    gen = torch.Generator(device=device).manual_seed(1)
    H = torch.randn(A.n_cols, HIDDEN, generator=gen, device=device)
    lib_ms, lib = _sparse_mm_ms(A, H)
    if not K9.gather_shape_ok(HIDDEN, H.data_ptr()):
        raise AssertionError("the slice's K9 must take the gather kernel")
    out = K9.spmm_plan(plan, H)
    err = _check("spmm_plan at slice shapes", out, K9.spmm_plan_plain(plan, H), K9_TOL)
    e_lib = _check("spmm_plan against torch.sparse.mm", out, lib, K2_TOL)
    e_old = _check("spmm_plan against the first kernel", out, K9._spmm_plan_single(plan, H), K9_TOL)
    del lib
    # the first kernel and the gather kernel in turns: first, gather, gather, first
    first = [cuda_ms(lambda: K9._spmm_plan_single(plan, H))]
    gather = [cuda_ms(lambda: K9._spmm_plan_gather(plan, H)) for _ in range(2)]
    first.append(cuda_ms(lambda: K9._spmm_plan_single(plan, H)))
    pre_ms = cuda_ms(lambda: K1._stage_h(H, None, A.n_cols, A.n_cols))
    Hb = H.to(torch.bfloat16)
    bf16_ms = cuda_ms(lambda: K9._spmm_plan_gather(plan, Hb))
    ms = float(np.median(gather))
    plain_ms = cuda_ms(lambda: K9.spmm_plan_plain(plan, H), reps=3)
    bound = _k9_bound(plan, H, out)
    b8 = RL.CostModel({"f32": bound["ops"]}, bound["nbytes"] - 4 * plan.slot_idx.numel()).bound()["bound_ms"]
    rec = {"spmm_plan": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], library_ms=lib_ms)}
    _log(f"spmm_plan at slice shapes [n={A.n_rows}, P={HIDDEN}]: gather kernel "
         + " / ".join(f"{m:.4f}" for m in gather) + f" ms ({A.nnz / (ms * 1e-3) / 1e6:.1f} M edges/s; the "
         f"bf16 pre-pass alone {pre_ms:.4f} ms, the kernel on a bf16 H {bf16_ms:.4f} ms), first kernel "
         + " / ".join(f"{m:.4f}" for m in first) + f" ms (same run, in turns), plain {plain_ms:.4f} ms "
         f"(median of 3), bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} (12 B of plan a slot; "
         f"at the 8 B of slot_cv the gather kernel reads: {b8:.4f} ms), max abs err {err:.3g}, against the "
         f"first kernel {e_old:.3g}; against the library product (f32 operands) {e_lib:.3g}")
    g = torch.randn(A.n_rows, HIDDEN, generator=gen, device=device)
    err_t = _check("spmm_plan on plan_t at slice shapes", K9.spmm_plan(plan_t, g),
                   K9.spmm_plan_plain(plan_t, g), K9_TOL)
    ms_t = cuda_ms(lambda: K9._spmm_plan_gather(plan_t, g))
    ms_t1 = cuda_ms(lambda: K9._spmm_plan_single(plan_t, g))
    _log(f"spmm_plan on plan_t: gather kernel {ms_t:.4f} ms, first kernel {ms_t1:.4f} ms, max abs err {err_t:.3g}")
    # the row pieces: slots a worker sums before a row is split (ROW_SEG_SLOTS)
    sweep = []
    for seg in (16, 32, 64, 128, 256):
        cut = K9.recut_rows(plan, seg)
        e = _check(f"spmm_plan at ROW_SEG_SLOTS={seg}", K9.spmm_plan(cut, H), out, K9_TOL)
        sweep.append(f"{seg}: {cuda_ms(lambda: K9._spmm_plan_gather(cut, H)):.4f} ms "
                     f"({cut.segments.n_seg} pieces, {cut.segments.n_fin} split rows, err {e:.3g})")
        del cut
    _log(f"spmm_plan gather kernel over ROW_SEG_SLOTS (plan default {K9.ROW_SEG_SLOTS}): " + "; ".join(sweep))
    del out, g, Hb

    # ---- serving: 3 requests, 2 launches each
    C = cfg["num_classes"]
    net = _gcn_net(cfg).to(device).eval()
    x = torch.from_numpy(data.x).to(device)
    with torch.no_grad():
        net(prep, x)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        times, per_request = [], []
        for _ in range(REQUESTS):
            before = K9.spmm_plan.launches
            t0 = time.perf_counter()
            logits = net(prep, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_request.append(K9.spmm_plan.launches - before)
        launches = _counts()
        _profile_forward(lambda: net(prep, x), "pallas GCN")
        with _plain_kernels():
            ref = net(prep, x)
        H1 = torch.matmul(x, net.conv1.weight)
        agg_ms = cuda_ms(lambda: agg_matmul(prep, H1))
    _log("pallas GCN forwards (K9 route): " + ", ".join(f"{m:.3f}" for m in times) + " ms")
    _log(f"launches in the pallas serving run: {launches} (K9 per request: {per_request})")
    _log(f"pallas aggregation (layer-1 input, K9): {agg_ms:.4f} ms")
    if per_request != [2] * REQUESTS or sum(launches.values()) != 2 * REQUESTS:
        raise AssertionError(f"K9 launches per request {per_request}, expected 2 each and no other kernel")
    _all_ring("pallas serving")
    if logits.shape != (A.n_rows, C):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    # layer 2 rounds its input to bf16: a last-bit difference in layer 1's
    # f32 sums flips some of those roundings, and a hub row adds up 10^5 of them
    e9 = _check("pallas logits vs plain-K9 forward", logits, ref, PALLAS_LOGIT_TOL)
    e2 = _check("pallas logits vs the K2 forward", logits, k2_logits, K2_TOL)
    _log(f"pallas logits: max abs err {e9:.3g} against the plain-K9 forward (tolerance {PALLAS_LOGIT_TOL}), "
         f"{e2:.3g} against the K2 forward, which writes bf16 (tolerance {K2_TOL}); "
         f"|logits| max {float(ref.abs().max()):.3g}")
    del ref, logits

    # ---- training: 3 epochs, K9 twice forward, twice backward, twice in the evaluation
    _add(launches, phase_train(data, prep, _gcn_net(cfg), device, "pallas GCN", {"spmm_plan": 6},
                               cfg_kw=PALLAS_CFG))

    # ---- runtime edge values: forward and both gradients against the plain version
    vals = torch.rand(prep.A.vals.shape[0], generator=gen, device=device) * (prep.A.vals != 0)
    Hs = torch.randn(A.n_cols, HIDDEN, generator=gen, device=device)
    R = torch.randn(A.n_rows, HIDDEN, generator=gen, device=device)

    def with_vals():
        v, h = vals.clone().requires_grad_(True), Hs.clone().requires_grad_(True)
        o = agg_matmul_with_vals(prep, v, h)
        (o * R).sum().backward()
        return o.detach(), v.grad, h.grad

    with_vals()  # warm-up: the allocator grows by the gathers' scratch
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    got = with_vals()
    torch.cuda.synchronize()
    wv_ms = (time.perf_counter() - t0) * 1e3
    wv = _counts()
    if wv["spmm_plan"] != 2 or sum(wv.values()) != 2:
        raise AssertionError(f"agg_matmul_with_vals launches {wv}, expected K9 forward and backward")
    _all_ring("agg_matmul_with_vals")
    with _plain_kernels():
        want = with_vals()
    errs = [_check(f"agg_matmul_with_vals {k}", a, b, K9_TOL)
            for k, a, b in zip(("out", "grad_vals", "grad_H"), got, want)]
    _log(f"agg_matmul_with_vals at 2^20 (P={HIDDEN}, random positive values): forward + backward {wv_ms:.3f} ms, "
         f"launches {wv}; max abs err out {errs[0]:.3g}, grad_vals {errs[1]:.3g}, grad_H {errs[2]:.3g} "
         f"against the plain version")
    _add(launches, wv)
    _log(f"peak device memory in the pallas phase: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del prep, plan, plan_t, got, want, vals, Hs, R
    torch.cuda.empty_cache()

    # ---- K9 alone at the config's own default tiling
    dflt = SGRACEConfig()
    t0 = time.perf_counter()
    small = K9.plan_spmm(A, rb=dflt.row_block, cb=dflt.col_block, be=dflt.edge_block, device=device)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    out = K9.spmm_plan(small, H)
    err = _check("spmm_plan at the default tiling", out, K9.spmm_plan_plain(small, H), K9_TOL)
    ms_d = cuda_ms(lambda: K9.spmm_plan(small, H))
    b_d = _k9_bound(small, H, out)
    _log(f"spmm_plan at the config's default tiling (forward plan only, plan_spmm): prepare {prep_s:.1f} s "
         f"rb={small.rb} cb={small.cb} be={small.be} groups={small.num_groups} "
         f"fill={small.nnz / small.perm.numel():.3f} plan bytes {_plan_bytes_k9(small) / 1e9:.3f} GB; "
         f"kernel {ms_d:.4f} ms, bound {b_d['bound_ms']:.4f} ms by {b_d['bound_by']}, max abs err {err:.3g}")
    return rec, launches


def _plan_gat_close(name: str, got, want) -> float:
    """``got`` against ``want`` at PLAN_GAT_TOL of ``want``'s largest
    magnitude; the largest gap over that magnitude."""
    torch.cuda.synchronize()
    scale = max(float(want.abs().max()), 1e-30)
    gap = float((got.float() - want.float()).abs().max())
    if not gap <= PLAN_GAT_TOL * scale:  # a NaN fails too
        raise AssertionError(f"{name}: largest gap {gap:.3g}, over {PLAN_GAT_TOL} of the largest magnitude {scale:.3g}")
    return gap / scale


def _kernel_ms(fn, names) -> dict:
    """Device ms of each kernel whose name holds one of ``names`` in one
    call of ``fn`` under torch.profiler (summed over its launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in names:
                if k in e.name:
                    out[k] += e.time_range.elapsed_us() / 1e3
    return out


def phase_plan_gat_products(device) -> tuple:
    """The plan attention (ops/plan_gat) at the gat-products cell's shapes:
    its graph (portbench's powerlaw_classes at 2^20 nodes, mean degree 50.5,
    seed PLAN_GAT_SEED), sym_norm and its prepare (the pallas kind at 1024 x
    1024 x 1024, ``gat_self_loops``: the plan attention, no mask tile). At 4
    heads of 128 and of 47 (the last layer's, staged at 48) each kernel runs
    once against its plain version on the same inputs (PLAN_GAT_TOL of the
    largest magnitude, the row max ``m`` equal) and is timed (CUDA events,
    median of 10; the plain version once) beside the bound of the gat
    family's count. Then the layer's entry, forward and backward, once with
    the counters set to 0 just before: one launch of each kernel, and no
    flash or other kernel's launch; its kernels' device ms under
    torch.profiler, the split rows' merge (merge_split_attention) among
    them. Returns (records, launches)."""
    from portbench import counts as PC
    from portbench import gen as PGEN
    from portbench.families import gat as FAM

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench", "configs",
                           "gat-products.json")) as f:
        cfg = json.load(f)
    n, H = cfg["num_nodes"], cfg["heads"]
    t0 = time.perf_counter()
    edges = PGEN.graph(cfg, PLAN_GAT_SEED, device).edges.cpu().numpy()
    A = sym_norm(edges, n)
    del edges
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = prepare_from_config(A, SGRACEConfig(**cfg["prepare"]), for_gat=True, gat_self_loops=True,
                               device=device)
    torch.cuda.synchronize()
    prep_s, nnz = time.perf_counter() - t0, A.nnz
    del A
    plan, plan_t = prep.plan, prep.plan_t
    if prep.kind != "pallas" or not prep.gat_on_plan or prep.gat_bsr is not None:
        raise AssertionError(f"gat-products must prepare the plan attention without mask tiles, got kind "
                             f"{prep.kind}, gat_on_plan {prep.gat_on_plan}, choice {prep.choice}")
    _log(f"gat-products graph: n={n} nnz={nnz} (with the zero-valued self-loops); generate + sym_norm "
         f"{gen_s:.1f} s, prepare {prep_s:.1f} s; plan: {plan.segments.n_seg} row pieces, "
         f"{plan.segments.n_fin} split rows, {plan.segments.n_part} partials; plan_t: {plan_t.segments.n_seg} "
         f"pieces, {plan_t.segments.n_fin} split rows")
    g = torch.Generator(device=device).manual_seed(PLAN_GAT_SEED)
    kw = dict(alpha=0.2, self_loops=True)
    rec, names = {}, ("plan_gat_fwd_kernel", "plan_gat_bwd_rows_kernel", "plan_gat_bwd_cols_kernel")
    for F in (cfg["hidden_channels"], cfg["num_classes"]):
        Fp = PG.plan_gat_width(H, F)
        s1 = torch.randn(n, H, generator=g, device=device)
        s2 = torch.randn(n, H, generator=g, device=device)
        Whs = PG.stage(torch.randn(n, H, F, generator=g, device=device), Fp)
        gOs = PG.stage(torch.randn(n, H, F, generator=g, device=device), Fp)
        out, m, l = PG.plan_gat_fwd(plan, s1, s2, Whs, **kw)
        want = PG.plan_gat_fwd_plain(plan, s1, s2, Whs, **kw)
        if not torch.equal(m, want[1]):
            raise AssertionError(f"plan_gat_fwd at F={F}: the row max differs from the plain version's")
        e_f = max(_plan_gat_close(f"plan_gat_fwd out at F={F}", out, want[0]),
                  _plan_gat_close(f"plan_gat_fwd l at F={F}", l, want[2]))
        del want
        t, u1, u2 = PG.plan_gat_bwd_rows(plan, s1, s2, m, l, Whs, gOs, **kw)
        want = PG.plan_gat_bwd_rows_plain(plan, s1, s2, m, l, Whs, gOs, **kw)
        e_r = max(_plan_gat_close(f"plan_gat_bwd_rows {k} at F={F}", a, b)
                  for k, a, b in zip(("t", "u1", "u2"), (t, u1, u2), want))
        del want
        dwh, ds2 = PG.plan_gat_bwd_cols(plan_t, s1, s2, m, l, t, Whs, gOs, **kw)
        want = PG.plan_gat_bwd_cols_plain(plan_t, s1, s2, m, l, t, Whs, gOs, **kw)
        e_c = max(_plan_gat_close(f"plan_gat_bwd_cols {k} at F={F}", a, b)
                  for k, a, b in zip(("dWh", "ds2"), (dwh, ds2), want))
        del want, out, dwh, ds2
        calls = (
            (lambda: PG.plan_gat_fwd(plan, s1, s2, Whs, **kw),
             lambda: PG.plan_gat_fwd_plain(plan, s1, s2, Whs, **kw), FAM.attention, e_f),
            (lambda: PG.plan_gat_bwd_rows(plan, s1, s2, m, l, Whs, gOs, **kw),
             lambda: PG.plan_gat_bwd_rows_plain(plan, s1, s2, m, l, Whs, gOs, **kw), FAM.attention_bwd_rows, e_r),
            (lambda: PG.plan_gat_bwd_cols(plan_t, s1, s2, m, l, t, Whs, gOs, **kw),
             lambda: PG.plan_gat_bwd_cols_plain(plan_t, s1, s2, m, l, t, Whs, gOs, **kw),
             FAM.attention_bwd_cols, e_c),
        )
        for name, (kern, plain, count, err) in zip(names, calls):
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain, reps=1, warmup=0)
            bound_ms = PC.least_time([count(name, n, nnz, H, F)]) * 1e3
            _log(f"{name} at gat-products shapes [n={n}, nnz={nnz}, H={H}, F={F} (staged {Fp})]: {ms:.4f} ms, "
                 f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by the gat family's count "
                 f"({100 * bound_ms / ms:.1f}% of it), largest gap {err:.3g} of the largest magnitude")
            if F == cfg["hidden_channels"]:
                rec[name] = dict(max_rel_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, F=F)
            else:
                rec[name].update(max_rel_err_f47=err, ms_f47=ms, plain_ms_f47=plain_ms, bound_ms_f47=bound_ms)
        del s1, s2, Whs, gOs, m, l, t, u1, u2

    # the layer's entry, forward and backward, at the hidden layers' width
    F = cfg["hidden_channels"]
    s1 = torch.randn(n, H, generator=g, device=device, requires_grad=True)
    s2 = torch.randn(n, H, generator=g, device=device, requires_grad=True)
    Wh = torch.randn(n, H, F, generator=g, device=device, requires_grad=True)
    gO = torch.randn(n, H, F, generator=g, device=device)

    def entry():
        PG.plan_gat_agg(prep, s1, s2, Wh, 0.2, self_loops=True).backward(gO)

    entry()  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    for k in ("launches", "launches_bwd_rows", "launches_bwd_cols", "launches_merge"):
        setattr(PG.plan_gat_agg, k, 0)
    entry()
    torch.cuda.synchronize()
    got = {k: getattr(PG.plan_gat_agg, k)
           for k in ("launches", "launches_bwd_rows", "launches_bwd_cols", "launches_merge")}
    split = [int(p.segments.n_fin > 0) for p in (plan, plan, plan_t)]
    want = dict(launches=1, launches_bwd_rows=1, launches_bwd_cols=1, launches_merge=sum(split))
    others = {k: v for k, v in _counts().items() if v}
    if got != want or others:
        raise AssertionError(f"plan_gat_agg forward + backward: counters {got}, expected {want}; other "
                             f"kernels launched {others}")
    dev_ms = _kernel_ms(entry, names + ("merge_split_attention", "sum_split_rows"))
    _log(f"plan_gat_agg forward + backward at F={F}: counters {got} (launches_merge: the launches on a plan "
         f"with split rows), no other kernel; device ms under torch.profiler: "
         + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items()))
    rec["merge_split_attention"] = dict(ms=dev_ms["merge_split_attention"], max_rel_err=rec[names[0]]["max_rel_err"],
                                        plain_ms=None, bound_ms=None)
    launches = {names[0]: got["launches"], names[1]: got["launches_bwd_rows"], names[2]: got["launches_bwd_cols"],
                "merge_split_attention": got["launches"] * split[0]}
    del prep, plan, plan_t, s1, s2, Wh, gO
    torch.cuda.empty_cache()
    return rec, launches


def _timed_variant(name, kern, plain, args, tol, reps_plain=3):
    """Drive one variant through its entry point REQUESTS times with the
    counts reset (its main path), hold it against its plain version, and
    time both (the plain version once with ``reps_plain`` 1). Returns (out,
    record without the bound, launches)."""
    _reset_counts()
    for _ in range(REQUESTS):
        out = kern(*args)
    torch.cuda.synchronize()
    launches = _counts()
    if launches[kern.__name__] != REQUESTS or sum(launches.values()) != REQUESTS:
        raise AssertionError(f"{name} launches {launches}, expected {kern.__name__} x{REQUESTS} only")
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    ref = plain(*args)
    e1.record()
    err = _check(name, out, ref, tol)
    ms = cuda_ms(lambda: kern(*args))
    # a slow plain version is timed once, on the call that made ``ref``
    plain_ms = e0.elapsed_time(e1) if reps_plain <= 1 else cuda_ms(lambda: plain(*args), reps=reps_plain)
    return out, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms), launches


def _cluster_sched(B, C):
    """The cluster K10's schedule for this card, as its wrapper builds it."""
    mode = K1._tile_mode(B.tiles, B.tb)
    n_sm = torch.cuda.get_device_properties(B.tiles.device).multi_processor_count
    return K1._cluster_sched(B, C, n_sm, K1.rowloop_cluster_occupancy(mode, C))


def _cluster_split(sched) -> str:
    """The heavy items of a cluster K10 schedule (each row block's live
    tiles and the tiles of each CTA), and the spread over the clusters."""
    lo, hi, rb, kind, cl = (t.cpu().numpy() for t in (sched.item_lo, sched.item_hi, sched.item_rb,
                                                        sched.item_kind, sched.cl_start))
    C = sched.C
    per = (hi - lo).reshape(-1, C)
    names = {K1.HEAVY: "whole", K1.UPPER: "upper half", K1.LOWER: "lower half"}
    parts = [f"row block {rb[i * C]} ({names[int(kind[i])]}): {per[i].sum()} live tiles, "
             f"{per[i].min()}-{per[i].max()} a CTA" for i in np.flatnonzero(kind != K1.LIGHT)]
    light = per[kind == K1.LIGHT]
    n_items = np.diff(cl)
    return (f"{sched.n_items} items over {sched.n_clusters} clusters ({n_items.min()}-{n_items.max()} each), "
            f"{sched.n_heavy} heavy (over {sched.heavy_min} live tiles: " + "; ".join(parts[:4])
            + ("; ..." if len(parts) > 4 else "") + f"), light CTAs at most {light.max() if light.size else 0} tiles")


def phase_variants_agg_slice(A, prep, device, lib_ms):
    """K10 and K11 at the slice's shapes (P = 128) beside K1 and K2 on the
    same tiles, and K10 beside K1 on a banded graph: the cluster K10 at both
    cluster sizes and the single-stage K10, the ring K11 at k 2 and 4 and
    the single-stage K11, in the same run."""
    gen = torch.Generator(device=device).manual_seed(3)
    H = torch.randn(prep.A.n_cols, HIDDEN, generator=gen, device=device)
    rec, launches = {}, {}
    B = prep.bsr
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    mode = K1._tile_mode(B.tiles, B.tb)

    occ = {C: K1.rowloop_cluster_occupancy(mode, C) for C in K1.ROWLOOP_CLUSTERS}
    _log(f"cluster K10 occupancy (cudaOccupancyMaxActiveClusters, {B.tiles.dtype} tiles, "
         f"{n_sm} SMs): " + ", ".join(f"C={C}: {n} clusters ({n * C} CTAs)" for C, n in occ.items()))
    # the plain K10 (the row-loop sum, independent of the cluster work
    # list) times the plain version; the cluster kernel's own plain version,
    # which sums each heavy item's partials in rank order, is held too
    out, r, n = _timed_variant("bsr_spmm_rowloop at slice shapes", K1.bsr_spmm_rowloop,
                               K1.bsr_spmm_rowloop_plain, (B, H), K1_TOL)
    if K1.bsr_spmm_rowloop.launches_single:  # the counts were reset when the main path began
        raise AssertionError("K10 at the slice's shapes must run the cluster kernel")
    sched = _cluster_sched(B, K1.ROWLOOP_CLUSTER)
    _check("bsr_spmm_rowloop at slice shapes against its cluster plain version", out,
           K1.bsr_spmm_rowloop_cluster_plain(B, H, sched), K1_TOL)
    k1 = K1.bsr_spmm(B, H)
    e1 = _check("bsr_spmm_rowloop against K1", out, k1, K1_TOL)
    k1_ms = cuda_ms(lambda: K1.bsr_spmm(B, H))
    single_ms = cuda_ms(lambda: K1._bsr_spmm_rowloop_single(B, H), reps=3)
    _check("single-stage bsr_spmm_rowloop at slice shapes", K1._bsr_spmm_rowloop_single(B, H), out, K1_TOL)
    bound = _agg_bound(B, H, out, "bf16")
    rec["bsr_spmm_rowloop"] = dict(**r, **bound, library_ms=lib_ms, earlier_ms=single_ms)
    _add(launches, n)
    longest = int(torch.bincount(B.ring.rb.long()).max())
    _log(f"bsr_spmm_rowloop on the slice's tiles [T={B.num_tiles}, live {B.ring.n_tile_steps}, longest live run "
         f"{longest} tiles, P={HIDDEN}]: cluster kernel C={K1.ROWLOOP_CLUSTER} {r['ms']:.4f} ms, single-stage "
         f"kernel {single_ms:.4f} ms, K1 (ring) on the same tiles {k1_ms:.4f} ms, torch.sparse.mm {lib_ms:.4f} ms, "
         f"plain {r['plain_ms']:.4f} ms, bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, "
         f"max abs err {r['max_abs_err']:.3g}, against K1 {e1:.3g}")
    ref = K1.bsr_spmm_rowloop_plain(B, H)
    for C in K1.ROWLOOP_CLUSTERS:
        sc = _cluster_sched(B, C)
        oc = K1._bsr_spmm_rowloop_cluster(B, H, C)
        ec = _check(f"cluster K10 C={C} at slice shapes", oc, K1.bsr_spmm_rowloop_cluster_plain(B, H, sc), K1_TOL)
        _check(f"cluster K10 C={C} at slice shapes against the plain K10", oc, ref, K1_TOL)
        ms_c = cuda_ms(lambda: K1._bsr_spmm_rowloop_cluster(B, H, C))
        _log(f"  cluster K10 C={C} on the slice: {ms_c:.4f} ms, max abs err {ec:.3g}; {_cluster_split(sc)}")
    del out, k1, ref

    band = _banded_graph(A.n_rows, A.n_rows // 4, 0)
    bp = prepare_adjacency(band, method="hybrid", tb=SLICE_SPLIT[0], rest_thresh=SLICE_SPLIT[1], build_transpose=False,
                           device=device)
    Bb = bp.bsr
    ob = K1.bsr_spmm_rowloop(Bb, H)
    sb = _cluster_sched(Bb, K1.ROWLOOP_CLUSTER)
    eb = _check("bsr_spmm_rowloop on the banded graph", ob, K1.bsr_spmm_rowloop_plain(Bb, H), K1_TOL)
    _check("bsr_spmm_rowloop on the banded graph against its cluster plain version", ob,
           K1.bsr_spmm_rowloop_cluster_plain(Bb, H, sb), K1_TOL)
    bb = _agg_bound(Bb, H, ob, "bf16")
    times = {f"cluster C={C}": cuda_ms(lambda: K1._bsr_spmm_rowloop_cluster(Bb, H, C)) for C in K1.ROWLOOP_CLUSTERS}
    times["single-stage"] = cuda_ms(lambda: K1._bsr_spmm_rowloop_single(Bb, H))
    times["K1 (ring)"] = cuda_ms(lambda: K1.bsr_spmm(Bb, H))
    _log(f"bsr_spmm_rowloop on the banded graph's tiles [n={band.n_rows}, T={Bb.num_tiles}, live "
         f"{Bb.ring.n_tile_steps}, longest live run {int(torch.bincount(Bb.ring.rb.long()).max())} tiles, "
         f"{sb.n_heavy} heavy items]: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
         + f", bound {bb['bound_ms']:.4f} ms by {bb['bound_by']}, max abs err {eb:.3g}")
    # an upper bound on what a heavy item adds: the same tiles with every row
    # block made heavy (two half-height items each, at heavy_min 0), each
    # item's partials summed through distributed shared memory; 15 of 16
    # ranks idle and H is read twice, so the reduction is not isolated
    C = K1.ROWLOOP_CLUSTER
    heavy = K1.cluster_schedule(Bb, C, 0, K1.rowloop_cluster_occupancy(K1._tile_mode(Bb.tiles, Bb.tb), C))
    oh = K1._bsr_spmm_rowloop_cluster(Bb, H, C, sched=heavy)
    eh = _check("bsr_spmm_rowloop with every row block heavy", oh, ob, K1_TOL)
    ms_h = cuda_ms(lambda: K1._bsr_spmm_rowloop_cluster(Bb, H, C, sched=heavy))
    per_cluster = heavy.n_heavy / heavy.n_clusters
    _log(f"cluster reduction cost on the banded graph: every row block heavy ({heavy.n_heavy} half-height "
         f"items, {per_cluster:.0f} a cluster of {C}) {ms_h:.4f} ms against {times[f'cluster C={C}']:.4f} ms "
         f"all light: at most {(ms_h - times[f'cluster C={C}']) * 1e3 / per_cluster:.2f} us a heavy item "
         f"(the half-tile work, the two cluster barriers and the rank-order sum together); max abs err {eh:.3g}")
    del oh
    del bp, Bb, ob

    k2 = K2.bsr_spmm_fused(prep.fused, H)
    k2_ms = cuda_ms(lambda: K2.bsr_spmm_fused(prep.fused, H))
    r1 = dict(r1_row=prep.r1_row.cpu().numpy(), r1_col=prep.r1_col.cpu().numpy())
    for k in (2, 4):
        t0 = time.perf_counter()
        plan = K2.build_fused_plan(B, prep.rest, attach_chunks=True, k_steps=k, **r1)
        build_s = time.perf_counter() - t0
        same = bool(torch.equal(plan.ring.step, prep.fused.ring.step)) and all(
            torch.equal(getattr(plan.ring.segments, f), getattr(prep.fused.ring.segments, f))
            for f in ("seg_rb", "seg_lo", "seg_hi", "seg_part"))
        out, r, n = _timed_variant(f"bsr_spmm_fused_k k={k} at slice shapes", K2.bsr_spmm_fused_k,
                                   K2.bsr_spmm_fused_k_plain, (plan, H), K2_TOL)
        if K2.bsr_spmm_fused_k.launches_single:
            raise AssertionError(f"K11 k={k} at the slice's shapes must run the ring kernel")
        e2 = _check(f"bsr_spmm_fused_k k={k} against K2", out, k2, K2_TOL)
        equal = bool(torch.equal(out, k2))
        if same and k == 2 and not equal:
            raise AssertionError("the ring K11 at k=2 on K2's ring schedule must equal K2's ring bit for bit")
        single_ms = cuda_ms(lambda: K2._bsr_spmm_fused_k_single(plan, H), reps=3)
        bound = _agg_bound(B, H, out, "bf16", plan=plan)
        _add(launches, n)
        _log(f"bsr_spmm_fused_k k={k} on the slice's split [steps {prep.fused.num_steps} -> {plan.num_steps}, "
             f"live {plan.ring.step.shape[0]} (the schedule of K2's ring: {same}), {k} slabs a stage, "
             f"{K2.k_ring_slab_depth(k)} deep, plan build {build_s:.1f} s]: ring kernel "
             f"{r['ms']:.4f} ms, single-stage kernel {single_ms:.4f} ms, K2 (ring) on the unpadded plan {k2_ms:.4f} ms, "
             f"torch.sparse.mm {lib_ms:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {bound['bound_ms']:.4f} ms by "
             f"{bound['bound_by']}, max abs err {r['max_abs_err']:.3g}, against K2 {e2:.3g} "
             f"({'equal bit for bit' if equal else 'not bit-equal'})")
        if k == 2 or r["ms"] < rec["bsr_spmm_fused_k"]["ms"]:
            rec["bsr_spmm_fused_k"] = dict(**r, **bound, library_ms=lib_ms, earlier_ms=single_ms)
    return rec, launches


def _k12_bound(B, pop, sb, tensors, F) -> dict:
    """Bound of K12 on this run's bitmap (``utils/roofline.cost_subskip``)."""
    return RL.cost_subskip(B, pop, sb, F, RL.nbytes(*tensors)).bound()


def phase_subskip(B, edges, device, label, record=False, plain_min_sb=1):
    """K12 at H = 1, F = 64 on tiles ``B`` (whose edges are ``edges``) at
    every sb from 8 to the tile size, beside K3 on the same tiles. The entry
    point is the main path (REQUESTS calls, every one on the ring kernel
    where its rule holds), held torch.equal to K3 on the same route and,
    from ``plain_min_sb`` on, to the plain K12 (which takes seconds a call
    at the slice's sizes, more as sb shrinks); the ring and the
    single-stage kernel timed in turns."""
    gen = torch.Generator(device=device).manual_seed(4)
    n = B.n_cols
    s1, s2, Wh = (x[:, 0] for x in _scores(n, 1, GAT_HIDDEN, gen, device))
    ring = FG._takes_ring(B, Wh)
    k3 = FG.flash_gat_forward(B, s1, s2, Wh)  # K3 on the route K12 takes
    k3_ms = cuda_ms(lambda: FG._flash_gat_forward_single(B, s1, s2, Wh))
    k3_ring_ms = cuda_ms(lambda: FG.flash_gat_forward(B, s1, s2, Wh))
    rec, launches = {}, {}
    for sb in (8, 16, 32, 64, 128, 256):
        if B.tb % sb:
            continue
        pop = FG.subblock_pop_bitmap(B, edges, sb)
        pop_t = torch.from_numpy(pop).to(device)
        args = (B, pop_t, s1, s2, Wh)
        kern = lambda *a: FG.flash_gat_forward_subskip(*a, sb=sb)
        kern.__name__ = "flash_gat_forward_subskip"
        plain = lambda *a: FG.flash_gat_forward_subskip_plain(*a, sb=sb)
        if sb >= plain_min_sb:
            out, r, n_l = _timed_variant(f"K12 sb={sb} ({label})", kern, plain, args, GAT_TOL, reps_plain=1)
        else:  # the plain version is held on the small graphs; here K3 is the reference
            out, r, n_l = _timed_variant(f"K12 sb={sb} ({label})", kern, lambda *a: k3, args, GAT_TOL,
                                         reps_plain=1)
            r["plain_ms"] = None
        if ring:
            _all_ring(f"K12 sb={sb} ({label})")
        err, ms, plain_ms = r["max_abs_err"], r["ms"], r["plain_ms"]
        if not torch.equal(out, k3):
            raise AssertionError(f"K12 sb={sb} ({label}) differs from K3 on the same tiles and route")
        single = [cuda_ms(lambda: FG._flash_gat_forward_subskip_single(*args, sb=sb))]
        if ring:
            _check(f"K12 sb={sb} ({label}) single-stage", FG._flash_gat_forward_subskip_single(*args, sb=sb),
                   out, GAT_TOL)
            times = [ms, cuda_ms(lambda: FG._flash_gat_forward_subskip_ring(*args, sb=sb))]
            single.append(cuda_ms(lambda: FG._flash_gat_forward_subskip_single(*args, sb=sb)))
            ms = float(np.median(times))
        slabs = FG.subskip_schedule(B, pop_t, sb).step
        fold_ms = None
        if ring:
            fold_ms = cuda_ms(lambda: FG._subskip_fold(B, pop_t, sb))
            if not torch.equal(FG._subskip_fold(B, pop_t, sb).step, slabs):
                raise AssertionError(f"K12 sb={sb} ({label}): the fold kernel differs from subskip_schedule")
        slabs = slabs[:, 3]
        n_slabs = int(sum(((slabs >> j) & 1).sum() for j in range(4)))
        bound = _k12_bound(B, pop, sb, (s1, s2, Wh, out), GAT_HIDDEN)
        bits = RL.pop_bits(pop)
        _add(launches, n_l)
        _log(f"flash_gat_forward_subskip sb={sb} on the {label} tiles [T={B.num_tiles}, tb={B.tb}, H=1, "
             f"F={GAT_HIDDEN}, populated sub-blocks {bits} of {B.num_tiles * (B.tb // sb) ** 2}, 64-column "
             f"slabs loaded {n_slabs} of {int(B.live.sum()) * (B.tb // 64)}]: "
             + (f"ring kernel {' / '.join(f'{m:.4f}' for m in times)} ms (of which the bitmap's fold into "
                f"the live steps {fold_ms:.4f}), " if ring else "")
             + f"single-stage kernel {' / '.join(f'{m:.4f}' for m in single)} ms; K3 at H=1 on the same tiles: "
             f"ring {k3_ring_ms:.4f} ms, single-stage {k3_ms:.4f} ms; plain "
             + (f"{plain_ms:.4f} ms" if plain_ms is not None else "not run at this sb")
             + f", bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, max abs err {err:.3g} against "
             + ("the plain K12" if plain_ms is not None else "K3") + ", equal to K3 on the same route")
        if record and plain_ms is not None and (not rec or ms < rec["flash_gat_forward_subskip"]["ms"]):
            rec["flash_gat_forward_subskip"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound,
                                                    library_ms=None, sb=sb, earlier_ms=float(np.median(single)))
    return rec, launches


# ------------------------------------------- the sampled, PPI and molecule loops


def _agg_kernel(prep):
    """The kernel ``agg_matmul`` launches on ``prep`` (None: its kind runs
    none)."""
    if prep.kind in ("bsr", "hybrid"):
        return "bsr_spmm_fused" if prep.fused is not None else "bsr_spmm"
    return "spmm_plan" if prep.kind == "pallas" else None


def _choice(prep) -> str:
    """What the cost model priced for ``prep`` (ms by kind) and its host seconds."""
    ch = prep.choice or {}
    costs = ", ".join(f"{k} {v * 1e3:.4f}" for k, v in ch.get("costs", {}).items())
    return f"model ms {{{costs}}}, split {ch.get('split')}, {ch.get('seconds', 0.0):.3f} s of host"


@contextlib.contextmanager
def _timed_calls(mod, name: str, calls: list):
    """``mod.name`` wrapped for the block: each call runs between two device
    synchronisations and appends (host seconds, its result, the launch
    counts before it, the launch counts after it) to ``calls``."""
    fn = getattr(mod, name)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        before = _counts()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, out, before, _counts()))
        return out

    setattr(mod, name, timed)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def _run_loop(label, loop_fn, spies):
    """Drive one training loop as its user calls it: counts set to 0 just
    before, read just after; every launch on a redesigned kernel; peak
    memory. ``spies`` maps names of ``train.loop`` to lists that take the
    timed calls (``_train_step`` always: step ms and launches a step)."""
    spies = {"_train_step": [], **spies}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with contextlib.ExitStack() as stack:
        for name, calls in spies.items():
            stack.enter_context(_timed_calls(TL, name, calls))
        t0 = time.perf_counter()
        state, hist = loop_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _counts()
    _all_ring(label)
    peak = torch.cuda.max_memory_allocated()
    steps = spies["_train_step"]
    per_step = [{k: after[k] - before[k] for k in after if after[k] != before[k]} for _, _, before, after in steps]
    step_ms = [1e3 * s for s, _, _, _ in steps]
    _log(f"{label}: {len(steps)} steps, device step (synchronised host clock) median {np.median(step_ms):.3f} ms, "
         f"min {min(step_ms):.3f}, max {max(step_ms):.3f}; launches in the run {launches}")
    _log(f"{label}: loss {hist.loss}, train {hist.train_acc}, test {hist.test_acc}, best {hist.best_test_acc}")
    _log(f"peak device memory in the {label} run: {peak / 2**30:.3f} GiB")
    if state.step != len(steps) or not all(np.isfinite(hist.loss)):
        raise AssertionError(f"{label}: step {state.step} of {len(steps)}, losses {hist.loss}")
    return state, hist, launches, per_step, wall


def _check_loop_step(label, net, forward, loss_of):
    """One step of a loop (train mode, dropout from a generator seeded 0,
    the loop's loss, backward) with the kernels, then with every kernel
    plain: the logits and every gradient at GRAD_TOL of their largest
    entry."""
    def run():
        net.train()
        net.zero_grad(set_to_none=True)
        logits = forward(torch.Generator(device=next(net.parameters()).device).manual_seed(0))
        loss_of(logits).backward()
        return logits.detach()

    before = _counts()
    got_logits = run()
    launched = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    got = {k: p.grad.clone() for k, p in net.named_parameters()}
    before = _counts()
    with _plain_kernels():
        ref = run()
    if not launched or _counts() != before:
        raise AssertionError(f"{label} step check: the kernel step launched {launched}, the plain step "
                             f"{ {k: v - before[k] for k, v in _counts().items() if v != before[k]} }")
    scale = float(ref.abs().max())
    torch.testing.assert_close(got_logits, ref, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                               msg=lambda m: f"{label} step logits: {m}")
    _log(f"{label} step logits vs the plain-kernel step: max err / max |logit| "
         f"{float((got_logits - ref).abs().max()) / max(scale, 1e-30):.3g}")
    _check_grads(label, net, got)


def _want_per_step(label, per_step, want):
    bad = [i for i, d in enumerate(per_step) if d != want]
    if bad:
        raise AssertionError(f"{label}: step {bad[0]} launched {per_step[bad[0]]}, expected {want}")


def _products_graph(cfg=SAMPLED_GRAPH):
    """The products-density graph, generated once for the sampled loop and
    the distributed GCN step."""
    t0 = time.perf_counter()
    data = products_density_graph(**cfg)
    gen_s = time.perf_counter() - t0
    _log(f"products-density graph {cfg}: {data.num_nodes} nodes, {data.edge_index.shape[1]} directed edges "
         f"({data.edge_index.shape[1] / data.num_nodes:.2f} a node); generated in {gen_s:.1f} s")
    return data


def phase_sampled(device, data, cfg=SAMPLED_GRAPH):
    """train_node_classifier_sampled on the products-density graph ``data``
    (``_products_graph(cfg)``): GCNModel(100, 128, 16), 4096 train seeds
    drawn with default_rng(0), batches of SAMPLED_BATCH, fanouts (10, 10),
    2 epochs, prepare="auto": each batch takes the kind the cost model
    prices cheapest (printed with its prices and the model's host seconds),
    and every step launches that kind's kernel four times (two forward, two
    on the transposed plan), all on the redesigned kernels."""
    t_phase = time.perf_counter()
    train = np.nonzero(data.train_mask)[0]
    seeds = np.random.default_rng(0).choice(train, SAMPLED_SEEDS, replace=False)
    mask = np.zeros_like(data.train_mask)
    mask[seeds] = True
    sdata = dataclasses.replace(data, train_mask=mask)
    net = _gcn_net(cfg)
    scfg = SGRACEConfig(num_epochs=SAMPLED_EPOCHS, learning_rate=0.01)
    norm, sampled, preps = [], [], []
    state, hist, launches, per_step, wall = _run_loop(
        "sampled GCN", lambda: train_node_classifier_sampled(
            net, sdata, scfg, batch_size=SAMPLED_BATCH, fanouts=(10, 10), seed=0, prepare="auto",
            device=device),
        {"sym_norm": norm, "make_neighbor_batches": sampled, "_prepare_backend": preps})
    full_s = preps[0][0]  # sym_norm runs inside the full graph's _prepare_backend
    full = preps[0][1]
    _log(f"  full graph (evaluation): kind={full.kind} n_pad={full.A.n_rows} ({_choice(full)})"
         + ("" if full.fused is None else f" tiles={full.bsr.num_tiles} rest chunks={full.fused.num_rest_chunks}"))
    batch_preps = preps[1:]
    n_batches = len(batch_preps)
    for i, (sec, p, _, _) in enumerate(batch_preps):
        f = p.fused
        layout = "" if f is None else (
            f" tiles={p.bsr.num_tiles} live={int(p.bsr.live.sum())} rest chunks={f.num_rest_chunks} "
            f"ring steps={f.ring.step.shape[0]} work items={f.ring.segments.n_seg}")
        _log(f"  sampled batch {i}: kind={p.kind} n_pad={p.A.n_rows} (dense bf16 {p.A.n_rows ** 2 * 2 / 2**20:.0f} "
             f"MiB, limit {D.DENSE_MAX_BYTES / 2**20:.0f}) e_pad={p.A.e_pad} nonzero edges="
             f"{int((p.A.vals != 0).sum())}{layout}; prepare {sec:.3f} s, of it the model {p.choice['seconds']:.3f} s "
             f"({_choice(p)})")
    # each step launches its batch's kernel four times (two forward, two on
    # the transposed plan), each evaluation the full graph's twice
    kerns = [_agg_kernel(p) for _, p, _, _ in batch_preps]
    for i, (k, got) in enumerate(zip(kerns, per_step)):
        if got != ({k: 4} if k else {}):
            raise AssertionError(f"sampled GCN: step {i} ({batch_preps[i][1].kind}) launched {got}")
    want = {}
    for k, c in [(k, 4) for k in kerns] + [(_agg_kernel(full), 2 * SAMPLED_EPOCHS)]:
        if k:
            want[k] = want.get(k, 0) + c
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"sampled GCN launches {launches}, expected {want}")
    sample_s = [sec for sec, _, _, _ in sampled]
    prep_s = [sec for sec, _, _, _ in batch_preps]
    epoch_ms = (wall - full_s) / SAMPLED_EPOCHS * 1e3
    _log(f"sampled GCN host seconds a batch: sampling and batching {sum(sample_s) / n_batches:.3f} s "
         f"(an epoch's make_neighbor_batches: {', '.join(f'{x:.3f}' for x in sample_s)} s), prepare "
         f"{np.mean(prep_s):.3f} s (min {min(prep_s):.3f}, max {max(prep_s):.3f}); full graph: sym_norm "
         f"{norm[0][0]:.3f} s, prepare {full_s - norm[0][0]:.3f} s; epoch {epoch_ms:.3f} ms (sampling, prepares, "
         f"{n_batches // SAMPLED_EPOCHS} steps and the full-graph evaluation); loop wall {wall:.3f} s")
    # one step of the loop on the last batch whose kind runs a kernel,
    # against the plain kernels
    last = max((i for i, k in enumerate(kerns) if k), default=None)
    if last is None:
        _log("sampled GCN: no batch's kind runs a kernel; no step to hold against the plain kernels")
        _log(f"phase sampled: {time.perf_counter() - t_phase:.1f} s wall")
        return {k: v for k, v in launches.items() if v}
    b = [bb for _, batches, _, _ in sampled for bb in batches][last]
    p = batch_preps[last][1]
    x = torch.from_numpy(b.x).to(device)
    y = torch.from_numpy(b.y).to(device).long()
    m = torch.from_numpy(b.seed_mask).to(device).float()
    gen = torch.Generator(device=device).manual_seed(0)
    _profile_forward(lambda: TL._train_step(state, lambda: _masked_xent(state.model(p, x, generator=gen), y, m)),
                     "sampled GCN train", "1 training step of the last batch")
    _check_loop_step("sampled GCN", state.model, lambda g: state.model(p, x, generator=g),
                     lambda lg: _masked_xent(lg, y, m))
    _log(f"phase sampled: {time.perf_counter() - t_phase:.1f} s wall")
    return {k: v for k, v in launches.items() if v}


def phase_ppi(device):
    """train_multilabel_inductive on PPI-shaped data (the real dataset's
    shape: 24 graphs, 20/2/2, 50 features, 121 labels) with
    GATModel(50, 64, 121, nheads=4, dropout=0) at lr 0.005
    (examples/ppi_gat.py), 2 epochs, prepare="auto": full-cover flash
    tiles, K3 forward, K4/K5 backward on the ring kernels."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tr, va, te = synthetic_ppi(**PPI)
    gen_s = time.perf_counter() - t0
    F, C = PPI["num_features"], PPI["num_labels"]
    net = GATModel(F, GAT_HIDDEN, C, nheads=GAT_HEADS, dropout=0.0)
    net.load_state_dict(_gat_weights(np.random.default_rng(0), F, GAT_HIDDEN, GAT_HEADS, C))
    pcfg = SGRACEConfig(num_epochs=PPI_EPOCHS, learning_rate=0.005)
    padded, preps, steps = [], [], []
    state, hist, launches, per_step, wall = _run_loop(
        "PPI GAT", lambda: train_multilabel_inductive(net, tr, va, te, pcfg, seed=0, log_every=1, prepare="auto",
                                                   device=device),
        {"_pad_multilabel_graph": padded, "_prepare_backend": preps, "_train_step": steps})
    for i, (sec, p, _, _) in enumerate(preps):
        B = p.flash_tiles
        _log(f"  PPI graph {i}: kind={p.kind} flash layout {'full cover' if p.gat_plan is None else 'hybrid'} "
             f"tb={B.tb} n_pad={p.A.n_rows} e_pad={p.A.e_pad} tiles={B.num_tiles} live={int(B.live.sum())} "
             f"work items={B.ring.segments.n_seg}; prepare {sec:.3f} s")
    if any(p.gat_plan is not None or p.flash_tiles is None for _, p, _, _ in preps):
        raise AssertionError("PPI graphs must prepare full-cover flash tiles")
    _want_per_step("PPI GAT", per_step, {"flash_gat_forward": 2, "flash_gat_bwd_row": 2, "flash_gat_bwd_col": 2})
    n_tr, n_all = len(tr), len(tr) + len(va) + len(te)
    want = {"flash_gat_forward": PPI_EPOCHS * 2 * (n_tr + n_all),
            "flash_gat_bwd_row": PPI_EPOCHS * 2 * n_tr, "flash_gat_bwd_col": PPI_EPOCHS * 2 * n_tr}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"PPI GAT launches {launches}, expected {want}")
    pad_s = [sec for sec, _, _, _ in padded]
    prep_s = [sec for sec, _, _, _ in preps]
    staging = sum(pad_s) + sum(prep_s)
    _log(f"PPI GAT host seconds a graph: batching (_pad_multilabel_graph) {np.mean(pad_s):.3f} s, prepare "
         f"{np.mean(prep_s):.3f} s (min {min(prep_s):.3f}, max {max(prep_s):.3f}); data generation {gen_s:.1f} s; "
         f"epoch {(wall - staging) / PPI_EPOCHS * 1e3:.3f} ms ({n_tr} steps and the F1 of {n_all} graphs); "
         f"loop wall {wall:.3f} s")
    _log(f"PPI GAT micro-F1 by epoch: train {hist.train_acc}, test {hist.test_acc}; best validation "
         f"{hist.best_test_acc}")
    # the loop learns: every epoch steps through the same training graphs in
    # the same order, so the epochs' mean losses compare, and the last comes
    # within PPI_LOSS_TOL of the entropy of the training labels' positive rate
    # (what a model that has learned that rate scores)
    loss = np.array([out.item() for _, out, _, _ in steps]).reshape(PPI_EPOCHS, n_tr).mean(axis=1)
    rate = float(np.mean([g.y.mean() for g in tr]))
    entropy = -(rate * np.log(rate) + (1 - rate) * np.log(1 - rate))
    _log(f"PPI GAT mean training loss by epoch: {loss.tolist()}; the labels' positive rate {rate:.4f}, "
         f"its entropy {entropy:.4f}")
    if not (loss[-1] < loss[0] and loss[-1] <= entropy * (1 + PPI_LOSS_TOL)):
        raise AssertionError(f"PPI GAT did not learn: mean loss by epoch {loss.tolist()}, label entropy {entropy}")
    _, x, y, m = padded[0][1]
    p0 = preps[0][1]
    x, y, m = (torch.from_numpy(a).to(device) for a in (x, y, m))

    def bce(logits):
        ls = torch.nn.functional.binary_cross_entropy_with_logits(logits, y, reduction="none")
        return torch.sum(ls * m[:, None]) / torch.clamp(torch.sum(m) * y.shape[1], min=1.0)

    _profile_forward(lambda: TL._train_step(state, lambda: bce(state.model(p0, x))), "PPI GAT train",
                     "1 training step of graph 0")
    _check_loop_step("PPI GAT", state.model, lambda g: state.model(p0, x, generator=g), bce)
    _log(f"phase PPI: {time.perf_counter() - t_phase:.1f} s wall")
    return want


def phase_molecules(device):
    """train_graph_classifier on MUTAG-shaped molecules (150 graphs, 120/30,
    batches of 32 at pad_to=64, as tests/test_training.py):
    MoleculeGCN(7, 64, 2), 36 epochs at lr 0.01, prepare="bsr", so that
    K2 walks the block-diagonal batches (two forward, two on fused_t a
    step; two an evaluated batch). Then ``calibrate`` on the trained
    model and MOL_QAT_EPOCHS fake-quant epochs on bf16 value tiles (K1).
    One step of each loop is held against the plain-kernel step."""
    t_phase = time.perf_counter()
    graphs = synthetic_molecules(num_graphs=150, seed=4)
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(graphs))
    t0 = time.perf_counter()
    train_b = make_batches([graphs[i] for i in idx[:120]], 32, rng=rng, pad_to=64)
    test_b = make_batches([graphs[i] for i in idx[120:]], 32, pad_to=64)
    batch_s = time.perf_counter() - t0
    net = MoleculeGCN(7, MOL_HIDDEN, 2)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         _slice_weights(np.random.default_rng(0), 7, MOL_HIDDEN, 2).items()})
    mcfg = SGRACEConfig(num_epochs=MOL_EPOCHS, learning_rate=0.01)
    preps = []
    state, hist, launches, per_step, wall = _run_loop(
        "MoleculeGCN", lambda: train_graph_classifier(net, train_b, test_b, mcfg, seed=0, prepare="bsr",
                                                      device=device),
        {"_prepare_backend": preps})
    for i, (sec, p, _, _) in enumerate(preps):
        _log(f"  molecule batch {i}: kind={p.kind} n_pad={p.A.n_rows} e_pad={p.A.e_pad} tb={p.bsr.tb} "
             f"tiles={p.bsr.num_tiles} live={int(p.bsr.live.sum())}; prepare {sec:.3f} s")
    _want_per_step("MoleculeGCN", per_step, {"bsr_spmm_fused": 4})
    n_tr, n_all = len(train_b), len(train_b) + len(test_b)
    want = MOL_EPOCHS * (4 * n_tr + 2 * n_all)
    if launches["bsr_spmm_fused"] != want or sum(launches.values()) != want:
        raise AssertionError(f"MoleculeGCN launches {launches}, expected bsr_spmm_fused {want} and nothing else")
    prep_s = sum(sec for sec, _, _, _ in preps)
    _log(f"MoleculeGCN host seconds a batch: batching {batch_s / n_all:.4f} s, prepare {prep_s / n_all:.4f} s; "
         f"epoch {(wall - prep_s) / MOL_EPOCHS * 1e3:.3f} ms ({n_tr} steps and the accuracy of {n_all} batches); "
         f"best test accuracy {hist.best_test_acc:.4f} (the reference's MUTAG anchor: 0.76 by epoch 36)")
    b, p0 = train_b[0], preps[0][1]
    x, gid = torch.from_numpy(b.x).to(device), torch.from_numpy(b.graph_ids).to(device).long()
    y, m = torch.from_numpy(b.y).to(device).long(), torch.from_numpy(b.label_mask).to(device).float()
    gen = torch.Generator(device=device).manual_seed(0)
    _profile_forward(lambda: TL._train_step(state, lambda: _masked_xent(
        state.model(p0, x, gid, b.num_graphs, generator=gen), y, m)), "MoleculeGCN train", "1 training step of batch 0")
    _check_loop_step("MoleculeGCN", state.model, lambda g: state.model(p0, x, gid, b.num_graphs, generator=g),
                     lambda lg: _masked_xent(lg, y, m))

    # quantization: calibrate the trained float model on the card from one
    # batch (the JAX package's calibrate takes one batch's arguments), then
    # 8-bit fake-quant epochs from that table on value tiles (K1)
    cal, cal_s = _timed(lambda: calibrate(state.model.eval(), p0, x, gid, b.num_graphs))
    raw = cal.raw
    _log(f"MoleculeGCN calibrate on train batch 0: {cal_s * 1e3:.1f} ms; f_max {raw['f_max']:.4g} "
         f"w_max {raw['w_max']:.4g} f_max2 {raw['f_max2']:.4g} w_max2 {raw['w_max2']:.4g}")
    qnet = MoleculeGCN(7, MOL_HIDDEN, 2, calibration=cal)
    qnet.load_state_dict(state.model.state_dict())
    qcfg = SGRACEConfig(num_epochs=MOL_QAT_EPOCHS, learning_rate=0.01, fake_quantization=True)
    qpreps = []
    qstate, qhist, qlaunches, q_per_step, qwall = _run_loop(
        "MoleculeGCN QAT", lambda: train_graph_classifier(qnet, train_b, test_b, qcfg, seed=0, prepare="bsr",
                                                          device=device),
        {"_prepare_backend": qpreps})
    if any(p.r1_row is not None or p.bsr.tiles.dtype != torch.bfloat16 for _, p, _, _ in qpreps):
        raise AssertionError("fake-quant batches must be prepared with bf16 value tiles")
    _want_per_step("MoleculeGCN QAT", q_per_step, {"bsr_spmm": 4})
    q_want = MOL_QAT_EPOCHS * (4 * n_tr + 2 * n_all)
    if qlaunches["bsr_spmm"] != q_want or sum(qlaunches.values()) != q_want:
        raise AssertionError(f"MoleculeGCN QAT launches {qlaunches}, expected bsr_spmm {q_want} and nothing else")
    qp0 = qpreps[0][1]
    _check_loop_step("MoleculeGCN QAT", qstate.model, lambda g: qstate.model(qp0, x, gid, b.num_graphs, generator=g),
                     lambda lg: _masked_xent(lg, y, m))
    _log(f"MoleculeGCN QAT: {MOL_QAT_EPOCHS} epochs in {qwall:.2f} s; best test accuracy {qhist.best_test_acc:.4f} "
         f"(float: {hist.best_test_acc:.4f})")
    _log(f"phase molecules: {time.perf_counter() - t_phase:.1f} s wall")
    return {"bsr_spmm_fused": launches["bsr_spmm_fused"], "bsr_spmm": qlaunches["bsr_spmm"]}


# --------------------------------------------------- the distributed path


def _tensor_bytes(obj) -> int:
    """Bytes of the tensors in a dataclass and the dataclasses it holds."""
    total = 0
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif dataclasses.is_dataclass(v):
            total += _tensor_bytes(v)
    return total


def _grads_of(forward, params: dict):
    """One forward and backward: (loss, the output, every parameter's
    gradient). ``forward`` returns (loss, output)."""
    for p in params.values():
        p.grad = None
    loss, out = forward()
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), out.detach(), {k: p.grad.detach().clone() for k, p in params.items()}


def _check_dist(label, got, ref) -> None:
    """A step's loss, output and gradients against a reference step's, at
    GRAD_TOL of each one's largest entry."""
    (gl, go, gg), (rl, ro, rg) = got, ref
    if not np.isfinite(gl) or abs(gl - rl) > GRAD_TOL * max(abs(rl), 1e-30):
        raise AssertionError(f"{label}: loss {gl} vs {rl}")
    errs = {}
    for k, g, r in [("output", go, ro)] + [(k, gg[k], rg[k]) for k in rg]:
        scale = float(r.abs().max())
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: {k} is not finite")
        torch.testing.assert_close(g, r, rtol=GRAD_TOL, atol=GRAD_TOL * scale, msg=lambda m: f"{label} {k}: {m}")
        errs[k] = float((g - r).abs().max()) / max(scale, 1e-30)
    _log(f"{label}: loss {gl:.6g} vs {rl:.6g}; max err / max |x| " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))


def _checked_launches(label, fn, want: dict):
    """Run ``fn`` between two reads of the counts; the launches must be
    ``want`` exactly."""
    before = _counts()
    res = fn()
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    if got != want:
        raise AssertionError(f"{label}: launched {got}, expected {want}")
    return res


def _dist_steps(label, step, want: dict) -> list:
    """The main path: counts set to 0 just before, DIST_STEPS calls of
    ``step`` between device synchronisations, each launching ``want``,
    every launch on the ring kernels. Returns the host milliseconds."""
    torch.cuda.synchronize()
    _reset_counts()
    ms = []
    for _ in range(DIST_STEPS):
        t0 = time.perf_counter()
        _checked_launches(f"{label} step", step, want)
        ms.append((time.perf_counter() - t0) * 1e3)
    _all_ring(label)
    _log(f"{label}: {DIST_STEPS} steps " + ", ".join(f"{m:.3f}" for m in ms) + f" ms (median {np.median(ms):.3f}, "
         f"synchronised host clock); launches {_counts()}")
    return ms


def _shard_edges(G, s) -> tuple:
    """(local, remote) edges of shard s with a nonzero value."""
    return int((G.vals_loc[s] != 0).sum()), int((G.vals_rem[s] != 0).sum())


def phase_dist_gcn(device, data, cfg=SAMPLED_GRAPH):
    """BASELINE.json config 5's training step, as
    benchmarks/bench_dist_train.main_large prepares and takes it, cut from
    2^22 nodes on 8 devices to the products-density graph at 2^20 on
    DIST_SHARDS shards of the in-process mesh: sym_norm,
    degree_balanced_order and permute_graph, the global rank1_factor,
    build_halo, build_halo_fused with the global factors; then
    dist_gnn_layer_halo_fused 100 -> 128 -> 128 (ReLU each), the head
    128 -> C, masked softmax cross-entropy, Adam at lr 0.01, parameters
    from default_rng(0) x 0.1. One warm-up step, DIST_STEPS timed steps,
    each launching K2 2 layers x 4 shards x (forward, fused_t) = 16 times on
    the ring kernel; one step's loss, logits and gradients held against the
    plain-kernel step and the kernel-free dist_gnn_layer_halo step. One card
    runs the shards in turn: no scaling efficiency is stated."""
    t_phase = time.perf_counter()
    S, n = DIST_SHARDS, data.num_nodes
    stages = {}
    t0 = time.perf_counter()
    A = sym_norm(data.edge_index, n)
    stages["sym_norm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    perm = degree_balanced_order(A, S)
    stages["degree_balanced_order"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    A_s, _ = permute_graph(A, perm)
    stages["permute_graph"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fac = rank1_factor(A_s)
    stages["rank1_factor"] = time.perf_counter() - t0
    if fac is None:
        raise AssertionError("the sym-normalized graph must factor as rank 1")
    t0 = time.perf_counter()
    G, n_pad = HALO.build_halo(A_s, S, device=device)
    stages["build_halo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    FP = HF.build_halo_fused(G, rank1_factors=fac)
    torch.cuda.synchronize()
    stages["build_halo_fused"] = time.perf_counter() - t0
    _log(f"dist GCN prepare host seconds (n={n}, nnz={A.nnz}, S={S}): "
         + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + f"; total {sum(stages.values()):.2f}")
    raw, bal = shard_edge_counts(A, S), shard_edge_counts(A_s, S)
    _log(f"dist GCN shard edges: contiguous split {raw.tolist()} (max/mean {raw.max() / raw.mean():.3f}), "
         f"degree-balanced {bal.tolist()} (max/mean {bal.max() / bal.mean():.3f})")
    _log(f"dist GCN halo plan: n_pad={n_pad} n_local={G.n_local} L={G.halo_len} tb={FP.tb} (the shard chooser's, "
         f"tb='auto') threshold {D._rest_thresh(FP.tb, FP.rank1, 2, K=FP.K)} K={FP.K} rank1={FP.rank1}")
    for s in range(S):
        loc, rem = _shard_edges(G, s)
        p, pt = FP.preps[s].fused, FP.preps[s].fused_t
        _log(f"  shard {s}: local edges {loc}, remote {rem} (local share {loc / max(loc + rem, 1):.4f}); "
             f"plan bytes {_tensor_bytes(p) / 2**20:.1f} MiB + transposed {_tensor_bytes(pt) / 2**20:.1f} MiB; "
             f"tiles {p.B.num_tiles} (live {int(p.B.live.sum())}), rest chunks {p.num_rest_chunks}, ring steps "
             f"{p.ring.step.shape[0]}, work items {p.ring.segments.n_seg}")
    comm = halo_comm(G, HIDDEN, backward=True)
    _log(f"dist GCN halo bytes a shard and step (halo_comm, f32 rows of width {HIDDEN}, 2 layers forward and "
         f"backward): {2 * comm.bytes_out:.0f} B = {2 * comm.bytes_out / 2**20:.2f} MiB ({comm.note}); "
         f"the all-gather layer's would be {2 * allgather_comm(n_pad, HIDDEN, S, backward=True).bytes_out / 2**20:.2f} MiB")

    x = torch.from_numpy(pad_nodes(data.x[perm], n_pad)).to(device)
    y = torch.from_numpy(pad_nodes(data.y[perm].astype(np.int64), n_pad)).to(device)
    m = torch.from_numpy(pad_nodes(data.train_mask[perm].astype(np.float32), n_pad)).to(device)
    F, C = cfg["num_features"], cfg["num_classes"]
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1).to(device).requires_grad_()
              for k, shape in (("W1", (F, HIDDEN)), ("W2", (HIDDEN, HIDDEN)), ("Wo", (HIDDEN, C)))}
    mesh = make_mesh(S, device=device)

    def forward(layer, *plan):
        h = layer(mesh, G, *plan, x, params["W1"], relu=True)
        h = layer(mesh, G, *plan, h, params["W2"], relu=True)
        logits = h @ params["Wo"]
        return _masked_xent(logits, y, m), logits

    fused = lambda: forward(HF.dist_gnn_layer_halo_fused, FP)
    opt = torch.optim.Adam(params.values(), lr=0.01, betas=(0.9, 0.999), eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        loss, _ = fused()
        loss.backward()
        opt.step()
        return loss

    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    _log(f"dist GCN warm-up step: {(time.perf_counter() - t0) * 1e3:.3f} ms")
    torch.cuda.reset_peak_memory_stats()
    want = {"bsr_spmm_fused": 2 * S * 2}
    _dist_steps("dist GCN training", step, want)
    launches = _counts()
    _log(f"peak device memory in the dist GCN steps: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    H = torch.randn(n_pad, HIDDEN, device=device)
    ex_ms = cuda_ms(lambda: HALO._exchange(mesh, G, mesh.split(H)))
    _log(f"dist GCN in-process exchange of one layer's rows (gather the send buffers, all_to_all as a device "
         f"copy, [{S}, {S}, {G.halo_len}, {HIDDEN}] f32): {ex_ms:.4f} ms (CUDA events; not a link)")
    _profile_forward(step, "dist GCN train", "1 training step")

    got = _checked_launches("dist GCN check step", lambda: _grads_of(fused, params), want)
    with _plain_kernels():
        plain = _checked_launches("dist GCN plain step", lambda: _grads_of(fused, params), {})
    _check_dist("dist GCN step vs the plain-kernel step", got, plain)
    edge = _checked_launches("dist GCN edge step",
                             lambda: _grads_of(lambda: forward(HALO.dist_gnn_layer_halo), params), {})
    _check_dist("dist GCN step vs the kernel-free dist_gnn_layer_halo step", got, edge)
    _log(f"phase dist GCN: {time.perf_counter() - t_phase:.1f} s wall")
    return {"bsr_spmm_fused": launches["bsr_spmm_fused"]}


def phase_dist_gat(A, x_np, device):
    """The halo GAT at full width on the GAT slice's graph (the 2^20
    power-law slice in degree order), build_halo on DIST_SHARDS shards:
    dist_gat_layer_halo_flash (4 heads of 64, W 100 x 256, attention
    [512, 1], ReLU) on build_halo_bsr(G, tb=256, mask=True), one warm-up and
    DIST_STEPS timed forward + backward passes, each launching K3, K4 and K5
    once a shard on the ring kernels; its output and the gradients of x, W
    and the attention vector held against the plain-kernel pass and the
    edge-path dist_gat_layer_halo. Then dist_gnn_layer_halo_bsr 100 -> 128
    on bf16 value tiles (build_halo_bsr(G, tb=256)): K1 forward and on the
    transposed tiles, once a shard each, against dist_gnn_layer_halo."""
    t_phase = time.perf_counter()
    S = DIST_SHARDS
    t0 = time.perf_counter()
    G, n_pad = HALO.build_halo(A, S, device=device)
    halo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    BP = HALO.build_halo_bsr(G, tb=256, mask=True)
    torch.cuda.synchronize()
    bsr_s = time.perf_counter() - t0
    loc = [_shard_edges(G, s) for s in range(S)]
    Bs, Bts = [p.bsr for p in BP.preps], [p.bsr_t for p in BP.preps]
    n_tiles = sum(B.num_tiles for B in Bs)
    _log(f"dist GAT prepare: build_halo {halo_s:.2f} s (L={G.halo_len}), build_halo_bsr(tb=256, mask=True) "
         f"{bsr_s:.2f} s: {n_tiles} full-cover local tiles ({sum(int(B.live.sum()) for B in Bs)} live; "
         f"{sum(RL.nbytes(B.tiles) for B in Bs) / 1e9:.3f} GB of int8 forward, "
         f"{sum(RL.nbytes(B.tiles) for B in Bts) / 1e9:.3f} GB transposed), local edges "
         f"{sum(a for a, _ in loc)} of {sum(a + b for a, b in loc)} "
         f"({sum(a for a, _ in loc) / max(sum(a + b for a, b in loc), 1):.4f})")
    for s in range(S):
        B = Bs[s]
        _log(f"  shard {s}: tiles {B.num_tiles} (live {int(B.live.sum())}), work items {B.ring.segments.n_seg}, "
             f"local {loc[s][0]} remote {loc[s][1]} edges")
    FH = DIST_GAT_HEADS * DIST_GAT_F
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1).to(device)
    x = torch.from_numpy(pad_nodes(x_np, n_pad)).to(device).requires_grad_()
    params = {"x": x, "W": t(x_np.shape[1], FH).requires_grad_(), "att": t(2 * FH, 1).requires_grad_()}
    mesh = make_mesh(S, device=device)

    def gat(layer, *plan):
        out = layer(mesh, G, *plan, x, params["W"], params["att"], nheads=DIST_GAT_HEADS, relu=True)
        return torch.sum(out ** 2), out  # smooth across the ReLU's kink, as tests/test_halo.py

    flash = lambda: gat(HALO.dist_gat_layer_halo_flash, BP)
    t0 = time.perf_counter()
    _grads_of(flash, params)
    _log(f"dist GAT warm-up forward + backward (builds each shard's transposed live tiles): "
         f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    torch.cuda.reset_peak_memory_stats()
    want = {"flash_gat_forward": S, "flash_gat_bwd_row": S, "flash_gat_bwd_col": S}
    _dist_steps("dist GAT forward + backward", lambda: _grads_of(flash, params), want)
    launches = _counts()
    _log(f"peak device memory in the dist GAT passes: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    _profile_forward(lambda: _grads_of(flash, params), "dist GAT", "1 forward + backward")
    got = _checked_launches("dist GAT check pass", lambda: _grads_of(flash, params), want)
    with _plain_kernels():
        plain = _checked_launches("dist GAT plain pass", lambda: _grads_of(flash, params), {})
    _check_dist("dist GAT flash vs the plain-kernel pass", got, plain)
    del plain
    edge = _checked_launches("dist GAT edge pass", lambda: _grads_of(lambda: gat(HALO.dist_gat_layer_halo), params),
                             {})
    _check_dist("dist GAT flash vs the edge-path dist_gat_layer_halo", got, edge)
    del got, edge, BP, Bs, Bts, B
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    BPv = HALO.build_halo_bsr(G, tb=256)
    torch.cuda.synchronize()
    _log(f"dist GCN-on-K1 prepare: build_halo_bsr(tb=256) bf16 value tiles {time.perf_counter() - t0:.2f} s, "
         f"{sum(RL.nbytes(p.bsr.tiles) for p in BPv.preps) / 1e9:.3f} GB forward, "
         f"{sum(RL.nbytes(p.bsr_t.tiles) for p in BPv.preps) / 1e9:.3f} GB transposed")
    p1 = {"x": x, "W": t(x_np.shape[1], HIDDEN).requires_grad_()}

    def gcn(layer, *plan):
        out = layer(mesh, G, *plan, x, p1["W"], relu=True)
        return torch.sum(out ** 2), out

    _reset_counts()
    t0 = time.perf_counter()
    got = _checked_launches("dist K1 layer pass", lambda: _grads_of(lambda: gcn(HALO.dist_gnn_layer_halo_bsr, BPv),
                                                                    p1), {"bsr_spmm": 2 * S})
    k1_ms = (time.perf_counter() - t0) * 1e3
    _all_ring("dist K1 layer")
    launches = _add(launches, _counts())
    _log(f"dist_gnn_layer_halo_bsr forward + backward: {k1_ms:.3f} ms (synchronised host clock, first call)")
    edge = _grads_of(lambda: gcn(HALO.dist_gnn_layer_halo), p1)
    _check_dist("dist_gnn_layer_halo_bsr vs dist_gnn_layer_halo", got, edge)
    _log(f"phase dist GAT: {time.perf_counter() - t_phase:.1f} s wall")
    return {k: v for k, v in launches.items() if v}


def phase_dist_dryrun(device):
    """The twin of the JAX package's dryrun_multichip(4) on the card at its
    own tiny shapes (24 nodes a shard, 16 features): every distributed
    layer kind and one Adam step, the tile layers at tb = DIST_DRYRUN_TB,
    where the single-stage kernels run (K1 and K2 forward and backward, K3,
    K4, K5 once a shard each). A finite loss and parameters, and the loss
    and gradients against the same step on the plain kernels."""
    t_phase = time.perf_counter()
    S, tb = DIST_SHARDS, DIST_DRYRUN_TB
    want = {"bsr_spmm": 2 * S, "bsr_spmm_fused": 2 * S, "flash_gat_forward": S, "flash_gat_bwd_row": S,
            "flash_gat_bwd_col": S}
    torch.cuda.synchronize()
    _reset_counts()
    loss, _, grads = _checked_launches("dist dry run", lambda: DR.dryrun_multichip(S, tb=tb, device=device), want)
    launches = _counts()
    _log(f"dist dry run (S={S}, tb={tb}): loss {float(loss):.6f}, launches {launches}, on the single-stage "
         f"kernels {sum(k.launches_single for k in KERNELS if hasattr(k, 'launches_single'))}")
    P = DR.build_problem(S, tb=tb, device=device)
    params = {k: v.requires_grad_() for k, v in dist_params_from_jax(DR.init_params(), device=device).items()}
    with _plain_kernels():
        plain = _checked_launches(
            "dist dry run plain step", lambda: _grads_of(lambda: (DR.loss_fn(P, params), torch.zeros(())), params), {})
    _check_dist("dist dry run vs the plain-kernel step", (float(loss), torch.zeros(()), grads), plain)
    _log(f"phase dist dry run: {time.perf_counter() - t_phase:.1f} s wall")
    return launches

# ------------------------------------------------- PR 15: peaks, cost model, examples


COST_TOL = 2.0  # a device-timed cost-table entry may sit within 2x of its re-measurement
ROUTE_TOL = 1.15  # auto's and for_gat's choice against the fastest measured candidate
COST_P = 128  # the model's lane width: every route is timed at P = 128, f32 H
COST_BUILD_BYTES = 8 << 30  # build a candidate only where its tiles fit this
COST_SHRINK = 0  # _measure_costs' node counts shifted down by this (a CPU rehearsal's sizes)
TIMING_ROUNDS = 5  # rounds of _interleaved_ms: host-bound calls drift by tens of percent between minutes


def _interleaved_ms(fns: dict, rounds: int = TIMING_ROUNDS, reps: int = 10) -> dict:
    """Each callable's ``cuda_ms`` in ``rounds`` rounds, the callables taken
    in turns in every round, so that a drift of the host's speed reaches
    all alike; the median of the rounds' medians."""
    got = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            got[k].append(cuda_ms(fn, reps=reps))
    return {k: float(np.median(v)) for k, v in got.items()}


def phase_peaks(device) -> dict:
    """The measured entries of ``utils/roofline.H100_PEAKS``: f32
    elementwise operations (chains of multiply-adds, two operations each,
    in registers), ``__expf`` and a device-to-device copy, each beside the
    table's value. The two compute rates run in a kernel compiled at run
    time by ``torch.cuda.jiterator`` (a measurement, on no path of the
    port)."""
    t0 = time.perf_counter()
    n, iters = 1 << 24, 256
    x = torch.rand(n, device=device)
    fma = torch.cuda.jiterator._create_jit_fn(
        "template <typename T> T fma_chain(T x) { T a = x, b = x + T(1), c = x + T(2), d = x + T(3); "
        f"for (int i = 0; i < {iters}; ++i) {{ a = a * T(0.999) + T(0.001); b = b * T(0.999) + T(0.001); "
        "c = c * T(0.999) + T(0.001); d = d * T(0.999) + T(0.001); } return a + b + c + d; }")
    ex = torch.cuda.jiterator._create_jit_fn(
        "template <typename T> T exp_chain(T x) { T a = x, b = x + T(0.5), c = x - T(0.5), d = -x; "
        f"for (int i = 0; i < {iters}; ++i) {{ a = __expf(a) - T(1); b = __expf(b) - T(1); "
        "c = __expf(c) - T(1); d = __expf(d) - T(1); } return a + b + c + d; }")
    ms_fma = cuda_ms(lambda: fma(x))
    ms_exp = cuda_ms(lambda: ex(x))
    src = torch.empty(1 << 28, device=device)
    dst = torch.empty_like(src)
    ms_copy = cuda_ms(lambda: dst.copy_(src))
    got = dict(elementwise_s=n * iters * 4 * 2 / (ms_fma * 1e-3),
               # each step of a chain: one exp and one subtraction, the exp's share counted
               exp_s=n * iters * 4 / (ms_exp * 1e-3),
               copy_bytes_s=2 * src.numel() * 4 / (ms_copy * 1e-3))
    for k, v in got.items():
        _log(f"peak {k}: measured {v:.4g} /s, table {getattr(RL.H100_PEAKS, k):.4g} /s")
    _log(f"published: memory {RL.H100_PEAKS.memory_bytes_s:.4g} B/s, operations {RL.H100_PEAKS.operations}; "
         f"phase peaks: {time.perf_counter() - t0:.1f} s wall")
    del src, dst
    return got


def _tile_graph(n, tb, per_rb, seed, values, edges=4, rows=None):
    """Edges in ``per_rb`` distinct tiles of every row block (column blocks
    spread over the width), ``edges`` random positions each; unit values
    (a rank-1 adjacency: mask tiles) or random ones (value tiles). ``rows``
    limits the row blocks that get tiles."""
    rng = np.random.default_rng(seed)
    n_rt = n // tb
    rb = np.arange(n_rt if rows is None else rows)
    cb = (rb[:, None] + np.arange(per_rb)[None, :] * max(n_rt // per_rb, 1)) % n_rt
    rb = np.broadcast_to(rb[:, None], cb.shape).reshape(-1)
    cb = cb.reshape(-1)
    r = np.repeat(rb * tb, edges) + rng.integers(0, tb, len(rb) * edges)
    c = np.repeat(cb * tb, edges) + rng.integers(0, tb, len(cb) * edges)
    key = np.unique(r.astype(np.int64) * n + c)
    v = rng.uniform(0.5, 1.5, len(key)).astype(np.float32) if values else np.ones(len(key), np.float32)
    return SparseMatrix.from_coo(key // n, key % n, v, (n, n))


def _chunk_graph(n, tb, per_rb, seed, dense_edges=0):
    """``per_rb`` remainder edges a row block (each in a tile of its own
    edges, under any threshold above 1) and, with ``dense_edges``, one
    tile a row block on the diagonal holding that many."""
    rng = np.random.default_rng(seed)
    n_rt = n // tb
    r = np.repeat(np.arange(n_rt) * tb, per_rb) + rng.integers(0, tb, n_rt * per_rb)
    c = (np.tile(np.arange(per_rb), n_rt) * tb + np.repeat(np.arange(n_rt), per_rb) * tb + tb) % n \
        + rng.integers(0, tb, n_rt * per_rb)
    if dense_edges:
        d = rng.integers(0, tb, (2, n_rt * dense_edges))
        r = np.concatenate([r, np.repeat(np.arange(n_rt) * tb, dense_edges) + d[0]])
        c = np.concatenate([c, np.repeat(np.arange(n_rt) * tb, dense_edges) + d[1]])
    key = np.unique(r.astype(np.int64) * n + c % n)
    return SparseMatrix.from_coo(key // n, key % n, np.ones(len(key), np.float32), (n, n))


def _measure_costs(device) -> dict:
    """Re-measure every device-timed entry of ``ops/dispatch.H100_COSTS``
    on synthetic layouts: one ``agg_matmul`` at P = 128, f32 H, CUDA
    events (the flash passes at H = 4, F = 64, and at H = 1 beside them).
    Each kind's fixed seconds a call on a small graph (1024 nodes, ~4 k
    edges; the kinds in turns, ``_interleaved_ms``), and its seconds a
    node row on a 2^20-node graph of a few edges. Slopes between two
    layouts on the same rows, so that those cancel: K2's live tile at each
    candidate size and form (few and many tiles a row block), the ring's
    full chunk at each width the plan's chooser takes (tb 256, K 128, 256
    and 512), the single-stage kernel's at tb 512 and 1024, a slot alone
    (one chunk of 64 and of 512 slots a row block, tb 256); K9's edge (the same groups full and sparse). With the call's and rows' seconds taken off: K9's
    group, the edge path's edge, the dense kind's bytes a second. The flash tile: K3 over full-cover tiles
    a head, a run from the same tiles over twice the row blocks, the
    backward's ratio from K4 + K5; a flash chunk: K6 at two chunk counts;
    the remainder backward: its torch terms at two edge counts."""
    gen = torch.Generator(device=device).manual_seed(5)
    P = COST_P
    got = {}

    def agg_ms(prep, n, reps=10):
        H = torch.randn(n, P, generator=gen, device=device)
        return cuda_ms(lambda: agg_matmul(prep, H), reps=reps)

    def two(preps, n):
        """Seconds of agg_matmul on each prep, the preps in turns."""
        H = torch.randn(n, P, generator=gen, device=device)
        return {k: v * 1e-3 for k, v in _interleaved_ms({k: (lambda p=p: agg_matmul(p, H))
                                                         for k, p in preps.items()}).items()}

    def prep_of(kind, A, **kw):
        return prepare_adjacency(A, method=kind, build_transpose=False, device=device, **kw)

    # each kind's fixed seconds a call, on a small graph (1024 nodes, ~4 k
    # edges in 16 tiles: the size where they decide), its kinds in turns;
    # and its seconds a node row
    call, row = {}, {}
    nd, n_small, n_big = 8192 >> COST_SHRINK, 1024, 1 << 20 >> COST_SHRINK
    kinds = (("dense", {}), ("xla", {}), ("bsr", dict(tb=256)), ("hybrid", dict(tb=256, rest_thresh=2)),
             ("pallas", {}))
    Hs = torch.randn(n_small, P, generator=gen, device=device)
    As = _tile_graph(n_small, 256, 4, 1, values=False, edges=256)
    small = {kind: prep_of(kind, As, **kw) for kind, kw in kinds}
    call = {k: v * 1e-3 for k, v in _interleaved_ms(
        {kind: (lambda p=p: agg_matmul(p, Hs)) for kind, p in small.items()}, reps=20).items()}
    t_big = agg_ms(prep_of("dense", _tile_graph(nd, 256, 1, 1, values=False)), nd) * 1e-3
    got["dense_bps"] = (nd * nd - n_small * n_small) * 2 / (t_big - call["dense"])
    call["dense"] -= n_small * n_small * 2 / got["dense_bps"]
    for kind, kw in kinds[1:]:
        t = agg_ms(prep_of(kind, _tile_graph(n_big, 256, 1, 2, values=False, rows=1), **kw), n_big) * 1e-3
        row[kind] = max(t - call[kind], 0.0) / n_big
    got["call_s"], got["row_s"] = call, row
    stamp = time.perf_counter()

    def section(name):
        nonlocal stamp
        _log(f"  cost measurement {name}: {time.perf_counter() - stamp:.1f} s")
        stamp = time.perf_counter()
    fixed = lambda kind, n: call[kind] + n * row[kind]
    # K2 a live tile: the ring at tb 64-256, the single-stage kernel past it;
    # the slope between two tile counts on the same rows (n, tiles a row
    # block: few, many), so the call's and the rows' seconds cancel
    tile_s = {}
    for tb, n, lo, hi in ((64, 1 << 16, 4, 32), (128, 1 << 16, 4, 32), (256, 1 << 16, 4, 28),
                          (512, 1 << 17, 1, 5), (1024, 1 << 17, 1, 3)):
        n >>= COST_SHRINK
        for rank1 in (True, False):
            preps = {per_rb: prep_of("bsr", _tile_graph(n, tb, per_rb, tb + per_rb, values=not rank1), tb=tb,
                                     rank1=rank1) for per_rb in (lo, hi)}
            if any((p.r1_row is not None) != rank1 for p in preps.values()):
                raise AssertionError(f"tile graph tb={tb}: rank1 {rank1} expected")
            t = two(preps, n)
            T = {k: int(p.bsr.live.sum()) for k, p in preps.items()}
            tile_s[(tb, D._tile_itemsize(tb, rank1, 2))] = (t[hi] - t[lo]) / (T[hi] - T[lo])
            del preps
    got["tile_s"] = tile_s
    section("tiles")
    # K2's remainder: the ring's full chunk at each width the plan's chooser
    # takes (tb 256, the same at tb 64-256 in calibration runs; one and five
    # chunks a row block, the row blocks halved as the width doubles, so each
    # layout holds ~0.65 M edges), the single-stage kernel's at 512 and 1024
    # (K = DEFAULT_K), and a slot (one chunk of 64 and of 512 slots a row
    # block)
    chunk_s, rest_chunk_s = {}, {}
    for tb, K, n, lo, hi in ((256, 128, 1 << 18, 128, 640), (256, 256, 1 << 17, 256, 1280),
                             (256, 512, 1 << 16, 512, 2560), (512, K2.DEFAULT_K, 1 << 18, 128, 1152),
                             (1024, K2.DEFAULT_K, 1 << 18, 128, 1152), (256, 512, 1 << 19, 64, 512)):
        n >>= COST_SHRINK
        preps = {per_rb: prep_of("hybrid", _chunk_graph(n, tb, per_rb, 7 + per_rb), tb=tb, rest_thresh=1 << 30,
                                 fused_k=K)
                 for per_rb in (lo, hi)}
        t = two(preps, n)
        (c1, s1_, t1), (c2, s2_, t2) = ((p.fused.num_rest_chunks, RL.live_slots(p.fused), t[k])
                                        for k, p in preps.items())
        del preps
        if c1 == c2:
            got["rest_slot_s"] = (t2 - t1) / (s2_ - s1_)
        elif tb == 256:
            rest_chunk_s[K] = (t2 - t1) / (c2 - c1)  # full chunks: a chunk with its K slots
        else:
            chunk_s[tb] = (t2 - t1) / (c2 - c1)
    got["rest_chunk_s"] = rest_chunk_s
    got["chunk_s"] = chunk_s
    section("chunks")
    # K9: the same groups full and sparse, then the groups' share
    n = 1 << 19 >> COST_SHRINK
    graphs = {k: _tile_graph(n, 1024, 4, 9, values=True, edges=k) for k in (1024, 64)}  # one group a tile
    preps = {k: prep_of("pallas", A) for k, A in graphs.items()}
    t = two(preps, n)
    (g1, e1, t1), (g2, e2, t2) = ((p.plan.num_groups, graphs[k].nnz, t[k] - fixed("pallas", n))
                                  for k, p in preps.items())
    edge_A = graphs[1024]
    del preps
    got["pallas_edge_s"] = (t1 - t2) / (e1 - e2)
    got["pallas_group_s"] = (t2 - e2 * got["pallas_edge_s"]) / g2
    section("K9")
    # the edge path an edge
    got["xla_edge_s"] = (agg_ms(prep_of("xla", edge_A), n) * 1e-3 - fixed("xla", n)) / edge_A.nnz
    # flash: a live tile (K3), a run, the backward's ratio (K4 + K5), per head
    flash_tile, per_head = {}, {}
    for tb, packed in ((64, False), (128, False), (256, False), (512, False), (1024, False), (1024, True)):
        n = (1 << 15 >> COST_SHRINK) if tb <= 256 else (1 << 16 >> COST_SHRINK)
        A = _tile_graph(n, tb, 6 if tb <= 512 else 3, 11 + tb, values=False)
        build = K1.bsr_bitmask_from_sparse if packed else K1.bsr_mask_from_sparse
        B = build(A, tb=tb, device=device)
        T = B.num_tiles
        heads = []
        for H in (4, 1):
            s1, s2, Wh = _scores(n, H, GAT_HIDDEN, gen, device)
            heads.append(cuda_ms(lambda: FG.flash_gat_forward(B, s1, s2, Wh)) * 1e-3 / T / H)
        per_head[(tb, packed)] = heads
        if not packed:
            flash_tile[tb] = heads[0]
        else:
            got["flash_packed_mult"] = heads[0] / flash_tile[1024]
        if tb == 256:
            s1, s2, Wh = _scores(n, 4, GAT_HIDDEN, gen, device)
            _, m, l = FG.flash_gat_forward(B, s1, s2, Wh, return_stats=True)
            gO = torch.randn(Wh.shape, generator=gen, device=device)
            ops = FG.bwd_operands(B, s1, s2, Wh, gO, m, l)
            t = FG.flash_gat_bwd_row(B, **ops)[0]
            bwd = cuda_ms(lambda: (FG.flash_gat_bwd_row(B, **ops), FG.flash_gat_bwd_col(B, **ops, t=t))) * 1e-3
            fwd = cuda_ms(lambda: FG.flash_gat_forward(B, s1, s2, Wh)) * 1e-3
            got["flash_train_passes"] = (fwd + bwd) / fwd
            # a run: the same tiles over twice the row blocks
            B2 = K1.bsr_mask_from_sparse(_tile_graph(2 * n, tb, 3, 12, values=False), tb=tb, device=device)
            s1b, s2b, Whb = _scores(2 * n, 4, GAT_HIDDEN, gen, device)
            fwd2 = cuda_ms(lambda: FG.flash_gat_forward(B2, s1b, s2b, Whb)) * 1e-3
            got["flash_run_elt_s"] = max((fwd2 - fwd) / (n // tb), 0.0) / 4 / tb
            del ops, m, l, gO, B2, s1b, s2b, Whb
        del B
    got["flash_tile_s"] = flash_tile
    got["flash_per_head_h4_h1"] = per_head
    section("flash tiles")
    # a flash chunk (K6) at two chunk counts; the remainder's backward terms
    n, tb = 1 << 18 >> COST_SHRINK, 256
    times, bwd_times = [], []
    for per_rb in (256, 1280):
        A = _chunk_graph(n, tb, per_rb, 13, dense_edges=128)
        prep = prepare_adjacency(A, method="xla", for_gat=True, gat_tb=tb, gat_rest_thresh=64, device=device)
        plan, rest = prep.gat_plan, prep.gat_rest
        heads = []
        for H in (4, 1):
            s1, s2, Wh = _scores(n, H, GAT_HIDDEN, gen, device)
            heads.append(cuda_ms(lambda: FG.flash_gat_hybrid_forward(plan, s1, s2, Wh)) * 1e-3)
        k3 = cuda_ms(lambda: FG.flash_gat_forward(plan.B, s1, s2, Wh)) * 1e-3  # H = 1: the tiles alone
        s1, s2, Wh = _scores(n, 4, GAT_HIDDEN, gen, device)
        _, m, l = FG.flash_gat_hybrid_forward(plan, s1, s2, Wh, return_stats=True)
        gO = torch.randn(n, 4, GAT_HIDDEN, generator=gen, device=device)

        def rest_bwd():
            edge, t, _, _ = FG._rest_row_terms(rest, s1, s2, Wh, gO, m[:n], l[:n], 0.2)
            return FG._rest_fan_in(edge, gO, t, n)

        bwd_times.append((rest.nnz, cuda_ms(rest_bwd, reps=5) * 1e-3))
        times.append((plan.num_rest_chunks, heads, k3))
        del prep, plan, rest, m, l, gO
    (c1, r1, k31), (c2, r2, _) = times
    got["flash_chunk_res_s"] = (r2[0] - r1[0]) / (c2 - c1) / 4
    got["flash_chunk_per_head_h4_h1"] = ((r2[0] - r1[0]) / (c2 - c1) / 4, (r2[1] - r1[1]) / (c2 - c1))
    got["flash_hybrid_fixed_s"] = max(r1[1] - c1 * (r2[1] - r1[1]) / (c2 - c1) - k31, 0.0)
    (e1, b1), (e2, b2) = bwd_times
    got["flash_edge_bwd_s"] = (b2 - b1) / (e2 - e1)
    got["flash_bwd_fixed_s"] = max(b1 - e1 * got["flash_edge_bwd_s"], 0.0)
    section("flash chunks")
    return got


# table entries held to COST_TOL of their re-measurement (CUDA-event times
# and their slopes); the intercepts and the second unknown of a two-point
# solve are printed beside them but move with noise
COST_HELD = ("tile_s", "chunk_s", "rest_chunk_s", "rest_slot_s", "call_s", "pallas_edge_s", "xla_edge_s",
             "dense_bps", "row_s", "flash_tile_s", "flash_packed_mult", "flash_train_passes", "flash_chunk_res_s", "flash_edge_bwd_s")


def phase_cost_model(device) -> dict:
    """Re-measure ``H100_COSTS`` (``_measure_costs``) and print each entry
    measured beside the table; fail where a held entry is off by more than
    COST_TOL (the table is stale)."""
    t0 = time.perf_counter()
    got = _measure_costs(device)
    table = D.H100_COSTS
    bad = []
    for k, v in got.items():
        if k.endswith("_h4_h1"):
            _log(f"cost {k}: " + (", ".join(f"{kk}: {vv[0]:.4g} / {vv[1]:.4g} s a head" for kk, vv in v.items())
                                   if isinstance(v, dict) else f"{v[0]:.4g} / {v[1]:.4g} s a head"))
            continue
        want = getattr(table, k)
        pairs = [(kk, vv, want.get(kk)) for kk, vv in v.items()] if isinstance(v, dict) else [("", v, want)]
        for kk, m, w in pairs:
            held = k in COST_HELD
            ratio = m / w if w else float("inf")
            _log(f"cost {k}{'' if kk == '' else f'[{kk}]'}: measured {m:.4g}, table {w if w is None else f'{w:.4g}'}"
                 f" (x{ratio:.3f}){'' if held else ', printed only'}")
            if held and not (1.0 / COST_TOL <= ratio <= COST_TOL):
                bad.append(f"{k}{kk}: measured {m:.4g} against {w}")
    _log(f"cost table ({table.card}): {len(bad)} held entries off by more than {COST_TOL}x; "
         f"phase cost model (measure): {time.perf_counter() - t0:.1f} s wall")
    if bad:
        raise AssertionError("ops/dispatch.H100_COSTS is stale: " + "; ".join(bad))
    return got


def _route_check(label, A, device) -> dict:
    """Every kind ``method="auto"`` prices on ``A``, built at the model's
    tile size or split (bsr only where its tiles fit COST_BUILD_BYTES) with
    its transposed plans as a training user gets them: the model's
    predicted ms of one ``agg_matmul`` at P = COST_P beside the measured ms
    (CUDA events: ``_interleaved_ms``, the routes in turns; f32 H,
    pre-pass and casts included), the prep's device GiB and the call's
    peak above it. ``auto``'s kind must
    measure within ROUTE_TOL of the fastest."""
    t0 = time.perf_counter()
    auto, auto_s = _timed(lambda: prepare_adjacency(A, device=device))
    ch = auto.choice
    est, (hy_tb, hy_thr) = ch["costs"], ch["best_hy"]
    fac = rank1_factor(A)
    kw = dict(rank1_factors=fac) if fac is not None else dict(rank1=False)
    H = torch.randn(A.n_cols, COST_P, generator=torch.Generator(device=device).manual_seed(8), device=device)
    rows, preps = [], {}
    for kind in est:
        if kind == auto.kind:
            prep, build_s = auto, auto_s
        elif kind == "bsr":
            r, c = D._edge_keys(A)
            T = len(D._tile_populations(r, c, (ch["best_tb"],))[ch["best_tb"]][0])
            nbytes = T * ch["best_tb"] ** 2 * (1 if fac is not None else 2)
            if nbytes > COST_BUILD_BYTES:
                rows.append(f"    bsr tb={ch['best_tb']}: predicted {est[kind] * 1e3:.4f} ms; not built "
                            f"({T} tiles, {nbytes / 2**30:.1f} GiB a direction)")
                continue
            prep, build_s = _timed(lambda: prepare_adjacency(A, method="bsr", tb=ch["best_tb"], device=device, **kw))
        elif kind == "hybrid":
            prep, build_s = _timed(lambda: prepare_adjacency(A, method="hybrid", tb=hy_tb, rest_thresh=hy_thr,
                                                             device=device, **kw))
        else:
            prep, build_s = _timed(lambda: prepare_adjacency(A, method=kind, device=device))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        agg_matmul(prep, H)
        torch.cuda.synchronize()
        preps[kind] = (prep, build_s, torch.cuda.max_memory_allocated() - base)
    measured = _interleaved_ms({kind: (lambda p=p: agg_matmul(p, H)) for kind, (p, _, _) in preps.items()})
    for kind, (prep, build_s, peak) in preps.items():
        where = {"bsr": f" tb={prep.bsr.tb}" if prep.bsr is not None else "",
                 "hybrid": f" tb={hy_tb} threshold {hy_thr}"}.get(kind, "")
        rows.append(f"    {kind}{where}: predicted {est[kind] * 1e3:.4f} ms, measured {measured[kind]:.4f} ms; prep "
                    f"{_tensor_bytes(prep) / 2**30:.3f} GiB, call peak +{peak / 2**30:.3f} GiB, build {build_s:.2f} s")
    del preps
    torch.cuda.empty_cache()
    best = min(measured, key=measured.get)
    _log(f"routes on {label} (n={A.n_rows}, nnz={A.nnz}): auto took {auto.kind} in {ch['seconds']:.3f} s of "
         f"the model (prepare {auto_s:.2f} s); fastest measured {best}")
    for r in rows:
        _log(r)
    ratio = measured[auto.kind] / measured[best]
    _log(f"  auto's {auto.kind}: {ratio:.3f} x the fastest (limit {ROUTE_TOL}); phase routes {label}: "
         f"{time.perf_counter() - t0:.1f} s wall")
    if ratio > ROUTE_TOL:
        raise AssertionError(f"{label}: auto took {auto.kind} at {measured[auto.kind]:.4f} ms, {ratio:.3f} x the "
                             f"fastest {best} ({measured[best]:.4f} ms)")
    return dict(auto=auto.kind, measured=measured, predicted={k: v * 1e3 for k, v in est.items()})


def _reference_adjacency():
    """phase_reference_format's adjacency, made as there (pubmed's
    descriptor, default_rng(11)) without the files."""
    desc = GIO.REFERENCE_DATASETS[REF_DATASET]
    n = desc["N_adj"]
    rng = np.random.default_rng(11)
    ptr, cols = _random_csr(rng, n, n, desc["NNZ_adj"])
    vals = rng.uniform(0.05, 1.0, desc["NNZ_adj"]).astype(np.float32)
    return SparseMatrix.from_coo(np.repeat(np.arange(n), np.diff(ptr)), cols, vals, (n, n))


def phase_routes(A, device) -> dict:
    """``_route_check`` on the GCN slice's graph ``A``, the reference-format
    pubmed graph, one PPI graph (padded as the loop pads it) and one
    molecule batch."""
    t0 = time.perf_counter()
    out = {"GCN slice": _route_check("the GCN slice (2^20, d16, degree order)", A, device)}
    out["pubmed"] = _route_check(f"the reference-format {REF_DATASET} graph", _reference_adjacency(), device)
    g = synthetic_ppi(**PPI)[0][0]
    n_pad = -(-g.num_nodes // 128) * 128
    out["PPI"] = _route_check("one PPI graph", TL._pad_multilabel_graph(g, n_pad, 1.0)[0], device)
    b = make_batches(synthetic_molecules(num_graphs=150, seed=4)[:32], 32, pad_to=64)[0]
    out["molecules"] = _route_check("one molecule batch", b.A, device)
    _log(f"phase routes: {time.perf_counter() - t0:.1f} s wall")
    return out


def _gat_entry(prep):
    if prep.gat_plan is not None:
        return lambda s1, s2, Wh: FG.gat_attention_agg_hybrid(prep.gat_plan, prep.gat_rest, s1, s2, Wh)
    return lambda s1, s2, Wh: FG.gat_attention_agg_fused(prep.flash_tiles, s1, s2, Wh)


def phase_gat_layouts(A, split_prep, device) -> None:
    """The flash layouts ``for_gat`` picks on the GAT slice's graph, for
    training (forward + backward: K6 or K3, then K4 + K5) and for serving
    (``gat_train=False``: the forward), against the hybrid split at
    SLICE_SPLIT (``split_prep``) and full cover where its tiles (reckoned
    from the keys) fit the table's budget; each predicted beside measured
    at H = 4, F = 64 (CUDA events). Each choice must measure within
    ROUTE_TOL of the fastest candidate for its use."""
    t0 = time.perf_counter()
    n = A.n_rows
    est = {u: D._flash_layout_costs(A, train=u == "train") for u in ("train", "serve")}
    preps = {(SLICE_SPLIT[0], False, SLICE_SPLIT[1]): split_prep}
    chosen = {}
    for use in ("train", "serve"):
        p, sec = _timed(lambda: prepare_adjacency(A, method="xla", for_gat=True, gat_train=use == "train",
                                                  device=device))
        lay = p.choice["flash"]
        chosen[use] = lay
        _log(f"for_gat ({use}) chose {lay} in {p.choice['seconds']:.2f} s of the model (prepare {sec:.1f} s)")
        preps.setdefault(lay, p)
    full = [k for k in est["train"] if k[2] is None and k[1] == D._packs(k[0])]
    if full:
        lay = min(full, key=est["train"].get)
        preps.setdefault(lay, prepare_adjacency(A, method="xla", for_gat=True, gat_tb=lay[0], device=device))
    else:
        _log(f"full cover: no tile size fits the table's budget of {D.H100_COSTS.flash_tile_budget / 2**30:.0f} GiB")
    gen = torch.Generator(device=device).manual_seed(6)
    s1, s2, Wh = _scores(n, GAT_HEADS, GAT_HIDDEN, gen, device)
    gO = torch.randn(Wh.shape, generator=gen, device=device)
    leaves = [t.clone().requires_grad_(True) for t in (s1, s2, Wh)]
    meas = {"train": {}, "serve": {}}
    for lay, p in preps.items():
        fn = _gat_entry(p)
        meas["serve"][lay] = cuda_ms(lambda: fn(s1, s2, Wh))

        def step():
            fn(*leaves).backward(gO)

        meas["train"][lay] = cuda_ms(step, reps=5)
        B = p.flash_tiles
        _log(f"  layout {lay}: {B.num_tiles} tiles ({RL.nbytes(B.tiles) / 2**30:.3f} GiB), "
             f"{p.gat_plan.num_rest_chunks if p.gat_plan is not None else 0} chunks; serve predicted "
             f"{est['serve'].get(lay, float('nan')) * 1e3:.4f} ms measured {meas['serve'][lay]:.4f} ms; train "
             f"predicted {est['train'].get(lay, float('nan')) * 1e3:.4f} ms measured {meas['train'][lay]:.4f} ms")
    for use in ("train", "serve"):
        m = meas[use]
        best = min(m, key=m.get)
        ratio = m[chosen[use]] / m[best]
        _log(f"for_gat {use}: {chosen[use]} at {ratio:.3f} x the fastest ({best}; limit {ROUTE_TOL})")
        if ratio > ROUTE_TOL:
            raise AssertionError(f"for_gat {use} chose {chosen[use]}: {ratio:.3f} x the fastest {best}")
    _log(f"phase GAT layouts: {time.perf_counter() - t0:.1f} s wall")


def phase_examples(device) -> dict:
    """The entry twin (``graft_entry.entry``) on the card against the same
    model on the CPU edge path (EXAMPLE_TOL of the largest logit); then
    the examples ``quantization_pipeline`` (default size, EXAMPLE_EPOCHS
    epochs: K2 or what auto picks, then K7), ``ppi_gat`` (synthetic, 1
    epoch) and ``distributed_training`` (4 in-process shards, 1 epoch),
    each with its launch counts."""
    t0 = time.perf_counter()
    total = {}
    _reset_counts()
    fn, (model, prep, x) = graft_entry.entry(device)
    out = fn(model, prep, x)
    launches = _counts()
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        ref = cpu(prep.A.to("cpu"), x.cpu())
    err = float((out.cpu() - ref).abs().max() / ref.abs().max())
    _log(f"entry twin on the card: logits {tuple(out.shape)}, {err:.3g} of the largest from the CPU edge path "
         f"(limit {EXAMPLE_TOL}); prep kind {prep.kind}, flash layout {prep.choice['flash']}; launches "
         f"{ {k: v for k, v in launches.items() if v} }")
    if not (err <= EXAMPLE_TOL and torch.isfinite(out).all()):
        raise AssertionError(f"entry twin: {err} of the largest logit from the CPU edge path")
    _add(total, launches)
    dev = ["--device", str(device)]
    for name, run in (("quantization_pipeline", lambda: EX_QP.main(["--epochs", str(EXAMPLE_EPOCHS)] + dev)),
                      ("ppi_gat", lambda: EX_PPI.main(["--epochs", "1"] + dev)),
                      ("distributed_training", lambda: EX_DIST.main(["--shards", "4", "--epochs", "1"] + dev))):
        _reset_counts()
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in _counts().items() if v}
        _log(f"example {name}: {time.perf_counter() - t1:.1f} s, launches {launches}")
        _add(total, launches)
    _log(f"phase examples: {time.perf_counter() - t0:.1f} s wall")
    return total


# --------------------- the last JAX functions: the K chooser, padding, the ablations

PAD_SEEDS = 2048  # the padding phase's sampled loop: two batches an epoch
# its products-density graph: batches of ~36 k nodes (hybrid, as at 2^20),
# and the loop's full-graph hybrid prepare in seconds, not half a minute
PAD_GRAPH = dict(SAMPLED_GRAPH, n=1 << 17)
L2E = 1.4426950408889634  # log2(e), the ring kernels' f32 constant


def _fast_ex2(y):
    """The ring kernels' ``fast_ex2`` (csrc/tile_ring.cuh), bit for bit:
    Schraudolph's exp of a base-2 exponent, int32(max(2^23 y + B, 0)) as
    f32 (one rounding after the sum; torch adds no FMA between two ops)."""
    return torch.clamp(y * 8388608.0 + 1064986816.0, min=0.0).to(torch.int32).view(torch.float32)


def _k3_fast_reference(B, L, s1, s2, Wh, m, ring: bool, alpha: float = 0.2):
    """K3 with fast_exp by the arithmetic of the kernel that walks the
    schedule ``L`` (the ring kernel: ``B.ring``, its live steps cut into
    segments; the single-stage kernel: ``B.segments``, every tile). Each segment's
    rows keep a running max from -1e5, moved once a 64-column slab (ring)
    or once a tile (single-stage) to LeakyReLU(s1 + the largest s2 over the
    row's edges there). An edge's p is Schraudolph's exp at the running max
    it meets: the ring's ``_fast_ex2`` of max(s2 L2E + (s1 - m) L2E,
    alpha s2 L2E + (alpha s1 - m) L2E), the single-stage kernel's
    ``FG._fast_exp`` of LeakyReLU(s1 + s2) - m. The kernels' rescales and
    the split runs' merge weigh it by exp(running max - ``m``), ``m`` the
    run's max. Returns out = sum bf16(p) bf16(Wh) / sum p and l."""
    if s1.dim() == 1:
        s1, s2, Wh = s1[:, None], s2[:, None], Wh[:, None]
    tb, H, F, dev = B.tb, Wh.shape[1], Wh.shape[2], Wh.device
    slab = 64 if ring else tb
    ns = tb // slab
    n_rt, n_ct = B.n_row_tiles, -(-B.n_cols // tb)
    S1 = torch.zeros(n_rt * tb, H, device=dev)
    S1[: s1.shape[0]] = s1
    S2 = torch.zeros(n_ct * tb, H, device=dev)
    S2[: s2.shape[0]] = s2
    W = torch.zeros(n_ct * tb, H, F, device=dev)
    W[: Wh.shape[0]] = Wh.to(torch.bfloat16).float()
    if ring:
        tiles, cbs, rbs = L.step[:, 0].long(), L.step[:, 1].long(), L.rb.long()
    else:
        tiles = torch.arange(B.num_tiles, device=dev)
        cbs, rbs = B.tile_cb.long(), B.tile_rb.long()
    S, G = L.segments if ring else L, tiles.shape[0]
    iota = torch.arange(tb, device=dev)
    batch = max(1, (1 << 24) // (tb * tb * H))

    def steps(i0):
        t, c, r = tiles[i0: i0 + batch], cbs[i0: i0 + batch], rbs[i0: i0 + batch]
        mask = FG._mask01(B.tiles[t], tb) > 0  # [b, rows, cols]
        return mask[..., None], r[:, None] * tb + iota, S1[r[:, None] * tb + iota], S2[c[:, None] * tb + iota], c

    run = torch.empty(G, ns, tb, H, device=dev)  # each (step, slab)'s max, then the running max
    for i0 in range(0, G, batch):
        mask, _, s1b, s2b, _ = steps(i0)
        big = torch.where(mask, s2b[:, None], -torch.inf).view(-1, tb, ns, slab, H).amax(3)
        x = s1b[:, :, None] + big
        run[i0: i0 + batch] = torch.maximum(x, alpha * x).permute(0, 2, 1, 3)
    run = run.view(G * ns, tb, H)
    lo, ln = S.seg_lo.long() * ns, (S.seg_hi.long() - S.seg_lo.long()) * ns
    run[lo[ln > 0]] = torch.clamp(run[lo[ln > 0]], min=-1e5)
    for j in range(1, int(ln.max()) if len(ln) else 0):
        q = lo[ln > j] + j
        run[q] = torch.maximum(run[q], run[q - 1])
    run = run.view(G, ns, tb, H)
    acc = torch.zeros(n_rt * tb, H, F, device=dev)
    lsum = torch.zeros(n_rt * tb, H, device=dev)
    for i0 in range(0, G, batch):
        mask, grow, s1b, s2b, c = steps(i0)
        ms = run[i0: i0 + batch].permute(0, 2, 1, 3)  # [b, rows, slabs, H]
        w = torch.exp(ms - m[grow][:, :, None])
        mc = ms.repeat_interleave(slab, dim=2)  # [b, rows, cols, H]
        if ring:
            sp = (s2b * L2E)[:, None]
            y = torch.maximum(sp + (s1b[:, :, None] - mc) * L2E, alpha * sp + (alpha * s1b[:, :, None] - mc) * L2E)
            p = _fast_ex2(y)
        else:
            e = s1b[:, :, None] + s2b[:, None]
            p = FG._fast_exp(torch.maximum(e, alpha * e) - mc)
        p = torch.where(mask, p, 0.0)
        b = p.shape[0]
        lsum.index_add_(0, grow.reshape(-1), (p.view(b, tb, ns, slab, H).sum(3) * w).sum(2).reshape(-1, H))
        q = p.to(torch.bfloat16).float() * w.repeat_interleave(slab, dim=2)
        prod = torch.einsum("brch,bchf->brhf", q, W[c[:, None] * tb + iota])
        acc.index_add_(0, grow.reshape(-1), prod.reshape(-1, H, F))
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out[: B.n_rows].view(B.n_rows, *Wh.shape[1:]), lsum


def _check_fast(name, res, ref, exact, B, ring, s1, s2, Wh) -> tuple:
    """K3 with fast_exp: m equal to the plain version's (it takes no exp);
    out and l at GAT_TOL of ``_k3_fast_reference`` on the schedule the
    kernel walks; the exact kernel's out must lie farther from that
    reference. Returns (the error against it, against the plain version at
    fast_exp, the exact kernel's against it)."""
    _check(name + " m", res[1], ref[1], 0.0)
    want, l = _k3_fast_reference(B, B.ring if ring else B.segments, s1, s2, Wh, ref[1], ring)
    err = _check(name, res[0].view(want.shape), want, GAT_TOL)
    torch.testing.assert_close(res[2], l, rtol=GAT_TOL, atol=1e-30, msg=lambda m: f"{name} l: {m}")
    far = float((exact.view(want.shape) - want).abs().max())
    if torch.equal(res[0], exact) or far <= err:
        raise AssertionError(f"{name}: fast_exp changed nothing (exact kernel {far:.3g} from the reference, "
                             f"the fast one {err:.3g})")
    return err, float((res[0].float() - ref[0].float()).abs().max()), far


def _unsplit_rows(S, tb: int, n_rows: int):
    """bool [n_rows]: the rows whose run the launch schedule's segments ``S``
    keep in one work item. K6 at ``noscore`` adds a chunk at the running max
    of its work item, so a run split over work items weighs its chunks
    otherwise than the plain version's one pass (JAX's semantics)."""
    rb = torch.arange(n_rows, device=S.fin_rb.device) // tb
    return ~torch.isin(rb, S.fin_rb.long())


def _flash_variants_small(device, gen):
    """The flash kernels' runtime flags on small cases, through the ring
    kernel and the single-stage one: K3 with fast_exp (``_check_fast``), K4/K5 with
    fast_exp under the same stats (GAT_TOL), K6 at noscore (on the rows of
    unsplit runs) and off, each against its plain version at the same flag;
    a flag must change the result."""
    A = _random_graph(3001, False, seed=40, isolated=5)
    for tb, H, F in ((128, 4, 64), (1024, 2, 16)):  # int8 masks (ring); packed masks (single-stage)
        B = prepare_adjacency(A, method="xla", for_gat=True, gat_tb=tb, build_transpose=False,
                              device=device).flash_tiles
        s1, s2, Wh = _scores(3001, H, F, gen, device)
        ring, bring = _flash_ring_rule(B, H, F), _bwd_ring_rule(B, H, F)
        ref = FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True, fast_exp=True)
        exact = FG.flash_gat_forward(B, s1, s2, Wh)
        for kern, r in [(FG.flash_gat_forward, ring)] + ([(FG._flash_gat_forward_single, False)] if ring else []):
            res = _flash_route(FG.flash_gat_forward, r, f"K3 fast_exp tb{tb}",
                               lambda: kern(B, s1, s2, Wh, return_stats=True, fast_exp=True))
            err, plain_err, far = _check_fast(f"K3 fast_exp tb{tb} {'ring' if r else 'single-stage'}", res, ref,
                                              exact, B, r, s1, s2, Wh)
            _log(f"  K3 fast_exp tb{tb} H{H} F{F} [{'ring' if r else 'single-stage'}]: err {err:.3g} against "
                 f"the kernel's arithmetic (the exact kernel: {far:.3g}; the plain version at fast_exp: "
                 f"{plain_err:.3g})")
        m, l = ref[1], ref[2]
        gO = torch.randn(Wh.shape, generator=gen, device=device)
        tref = FG.flash_gat_bwd_row_plain(B, s1, s2, m, l, Wh, gO, fast_exp=True)
        cref = FG.flash_gat_bwd_col_plain(B, s1, s2, m, l, tref[0], Wh, gO, fast_exp=True)
        exact_t = FG.flash_gat_bwd_row(B, s1, s2, m, l, Wh, gO)[0]
        runs = [(FG.flash_gat_bwd_row, FG.flash_gat_bwd_col, bring)]
        if bring:
            runs.append((FG._flash_gat_bwd_row_single, FG._flash_gat_bwd_col_single, False))
        for row, col, r in runs:
            label = f"tb{tb} {'ring' if r else 'single-stage'}"
            got = _flash_route(FG.flash_gat_bwd_row, r, f"K4 fast_exp {label}",
                               lambda: row(B, s1, s2, m, l, Wh, gO, fast_exp=True))
            err = max(_check(f"K4 fast_exp {label}", g, rf, GAT_TOL) for g, rf in zip(got, tref))
            if torch.equal(got[0], exact_t):
                raise AssertionError(f"K4 {label}: fast_exp changed nothing")
            got = _flash_route(FG.flash_gat_bwd_col, r, f"K5 fast_exp {label}",
                               lambda: col(B, s1, s2, m, l, tref[0], Wh, gO, fast_exp=True))
            err = max(err, *(_check(f"K5 fast_exp {label}", g, rf, GAT_TOL) for g, rf in zip(got, cref)))
            _log(f"  K4/K5 fast_exp {label} H{H} F{F}: err {err:.3g}")
    tb = 128
    part, rest = split_by_tile_density(A, tb, 40)
    B = K1.bsr_mask_from_sparse(part, tb=tb, cover_rows=True, cover_cols=True, device=device)
    plan = K2.build_fused_plan(B, _drop_zero_val_edges(rest), attach_chunks=True)
    s1, s2, Wh = _scores(3001, 4, 64, gen, device)
    full = FG.flash_gat_hybrid_forward_plain(plan, s1, s2, Wh)
    if not _flash_ring_rule(B, 4, 64, plan.K):
        raise AssertionError("the K6 mode case must take the ring kernel")
    for mode in ("noscore", "off"):
        ref = FG.flash_gat_hybrid_forward_plain(plan, s1, s2, Wh, _chunk_mode=mode)
        if torch.equal(ref, full):
            raise AssertionError(f"K6 {mode}: the mode changed nothing")
        for kern, S, r in ((FG.flash_gat_hybrid_forward, plan.ring.segments, True),
                           (FG._flash_gat_hybrid_forward_single, plan.segments, False)):
            name = f"K6 {mode} {'ring' if r else 'single-stage'}"
            out = _flash_route(FG.flash_gat_hybrid_forward, r, name, lambda: kern(plan, s1, s2, Wh, _chunk_mode=mode))
            keep = _unsplit_rows(S, tb, out.shape[0]) if mode == "noscore" else torch.ones_like(out[:, 0, 0], dtype=bool)
            err = _check(name, out[keep], ref[keep], GAT_TOL)
            # with the stats the chunks are scored whatever the mode (the backward's forward)
            stats = kern(plan, s1, s2, Wh, return_stats=True, _chunk_mode=mode)
            _check(f"{name} with stats (full)", stats[0], full, GAT_TOL)
            _log(f"  {name}: err {err:.3g} on {int(keep.sum())} of {keep.numel()} rows (split runs: {S.n_fin})")


def phase_fill_ins(device) -> None:
    """The ported JAX functions that are plain tensor code, one short call
    each on the card: ``bsr_spmm_xla`` against the plain K1 (the same bf16
    products, f32 sums in another order: K1_TOL); ``pack_mask_bsr``
    equal to the host bitmask build and unpacking to the mask tiles; the
    sharded train-state pair round-tripping a GCNModel's parameters and Adam
    state."""
    from sgracex1_tpu_torch.train.checkpoint import load_train_state_sharded, save_train_state_sharded

    t0 = time.perf_counter()
    stamp = [t0]

    def lap():
        torch.cuda.synchronize()
        stamp.append(time.perf_counter())
        return stamp[-1] - stamp[-2]

    gen = torch.Generator(device=device).manual_seed(13)
    A = _random_graph(4096, True, seed=50)
    B = K1.bsr_from_sparse(A, tb=256, cover_rows=True, device=device)
    H = torch.randn(A.n_cols, 64, generator=gen, device=device)
    err = _check("bsr_spmm_xla", K1.bsr_spmm_xla(B, H), K1.bsr_spmm_plain(B, H), K1_TOL)
    laps = [lap()]
    M = K1.bsr_mask_from_sparse(A, tb=1024, cover_rows=True, device=device)
    P = K1.pack_mask_bsr(M, batch_tiles=3)
    if not torch.equal(P.tiles, K1.bsr_bitmask_from_sparse(A, tb=1024, cover_rows=True, device=device).tiles):
        raise AssertionError("pack_mask_bsr differs from bsr_bitmask_from_sparse")
    if not (torch.equal(K1.unpack_mask01_tile(P.tiles, 1024), M.tiles.float())
            and torch.equal(K1.unpack_mask_tile(P.tiles, 1024), M.tiles > 0)):
        raise AssertionError("unpacking pack_mask_bsr's tiles does not give the mask tiles")
    laps.append(lap())
    prep = prepare_adjacency(_random_graph(4096, False, seed=51), method="xla", device=device)
    x = torch.randn(A.n_rows, 16, generator=gen, device=device)
    y = torch.randint(0, 4, (A.n_rows,), generator=gen, device=device)
    m = torch.ones(A.n_rows, device=device)
    laps.append(lap())
    # one training step, lapped by part: the run's first backward and Adam step on the card
    net = GCNModel(16, 32, 4, generator=torch.Generator().manual_seed(0)).to(device)
    laps.append(lap())
    a = TL.TrainState(model=net, optimizer=torch.optim.Adam(net.parameters(), lr=0.01))
    laps.append(lap())
    loss = _masked_xent(net(prep, x), y, m)
    laps.append(lap())
    loss.backward()
    laps.append(lap())
    a.optimizer.step()
    a.step += 1
    laps.append(lap())
    # the state to load into: a copy with every parameter and Adam entry moved
    b = copy.deepcopy(a)
    with torch.no_grad():
        for q in list(b.model.parameters()) + [v for st in b.optimizer.state.values() for v in st.values()]:
            q.add_(1.0)
    b.step = 0
    with tempfile.TemporaryDirectory() as d:
        save_train_state_sharded(d, a, a.step)
        load_train_state_sharded(d, b, a.step)
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    if not (all(torch.equal(p, q) for p, q in zip(a.model.state_dict().values(), b.model.state_dict().values()))
            and all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i]) and b.step == a.step):
        raise AssertionError("the sharded train state did not round-trip")
    laps.append(lap())
    _log(f"fill-ins on the card: bsr_spmm_xla err {err:.3g} on {B.num_tiles} tiles; pack_mask_bsr equal to the "
         f"host bitmask on {P.num_tiles} tiles; sharded train state ({len(oa)} Adam entries) round-tripped; "
         f"seconds: xla {laps[0]:.2f}, pack {laps[1]:.2f}, the edge-path prep {laps[2]:.2f}, one GCN step on "
         f"it: the model {laps[3]:.2f}, the run's first optimizer {laps[4]:.2f}, forward {laps[5]:.2f}, "
         f"backward {laps[6]:.2f}, Adam step {laps[7]:.2f}; save and load {laps[8]:.2f}; phase fill-ins: "
         f"{time.perf_counter() - t0:.1f} s wall")


# the K chooser's second graph: uniform random pairs, both directions, so
# each row block of 256 holds ~190 remainder edges (tiles of ~1 edge stay
# below the split's threshold), where the card's table takes K = 256
KC_SPARSE = dict(n=1 << 19, pairs_a_node=0.375, seed=60)


def _k_widths(label, prep, device, gen) -> dict:
    """K2 on ``prep``'s forward and transposed plans rebuilt at K 128, 256
    and 512 (the prep's own, at the chosen K, among them), each held
    against ``bsr_spmm_fused_plain`` on the same plan and timed in turns;
    the chosen K within ROUTE_TOL of the fastest."""
    H = torch.randn(prep.A.n_cols, HIDDEN, generator=gen, device=device)
    g = torch.randn(prep.A.n_rows, HIDDEN, generator=gen, device=device)
    r1 = {} if prep.r1_row is None else dict(r1_row=prep.r1_row.cpu().numpy(), r1_col=prep.r1_col.cpu().numpy())
    rt = {} if not r1 else dict(r1_row=r1["r1_col"], r1_col=r1["r1_row"])
    rest_t = prep.rest.transpose() if prep.rest is not None else None
    out = {}
    for name, own, B, rest, kw, arg in (("fused", prep.fused, prep.bsr, prep.rest, r1, H),
                                        ("fused_t", prep.fused_t, prep.bsr_t, rest_t, rt, g)):
        plans = {K: own if own.K == K else K2.build_fused_plan(B, rest, K=K, attach_chunks=True, **kw)
                 for K in (128, 256, 512)}
        for K, p in plans.items():
            _check(f"K2 on {label}'s {name} at K={K}", K2.bsr_spmm_fused(p, arg), K2.bsr_spmm_fused_plain(p, arg),
                   K2_TOL)
        ms = _interleaved_ms({K: (lambda p=p: K2.bsr_spmm_fused(p, arg)) for K, p in plans.items()})
        best = min(ms, key=ms.get)
        rows = []
        for K, p in plans.items():
            live = RL.live_slots(p)
            slots = p.num_rest_chunks * K
            rows.append(f"K={K}{' (chosen)' if K == own.K else ''}: {ms[K]:.4f} ms, {p.num_rest_chunks} chunks, "
                        f"{live} live slots of {slots}, dead share {1 - live / max(slots, 1):.4f}")
        _log(f"K chooser on {label}'s {name} (K2 at P={HIDDEN}, f32 in): " + "; ".join(rows))
        if ms[own.K] > ROUTE_TOL * ms[best]:
            raise AssertionError(f"K chooser on {label}'s {name}: chose K={own.K} at {ms[own.K]:.4f} ms, "
                                 f"K={best} measures {ms[best]:.4f} ms")
        out[name] = dict(chosen=own.K, ms=ms)
        del plans
    return out


def phase_k_chooser(prep, device, cfg=KC_SPARSE) -> dict:
    """The fused plan's K chooser where the card's table takes the default
    width and where it takes a wider one (``_k_widths``): the GCN slice's
    hybrid prep (SLICE_SPLIT) and the hybrid prep at tb SLICE_SPLIT[0] of a
    sparse uniform graph (``cfg``), whose plans must take K > DEFAULT_K.
    Chunks, live slots and the dead-slot share at each K."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(11)
    out = {"the slice": _k_widths("the slice", prep, device, gen)}
    n = cfg["n"]
    pairs = np.random.default_rng(cfg["seed"]).integers(0, n, (2, int(cfg["pairs_a_node"] * n)))
    A = sym_norm(np.concatenate([pairs, pairs[::-1]], axis=1), n)
    t1 = time.perf_counter()
    sparse = prepare_adjacency(A, method="hybrid", tb=SLICE_SPLIT[0], device=device)
    _log(f"K chooser's sparse graph {cfg}: {A.nnz} edges; hybrid prepare at tb {SLICE_SPLIT[0]} in "
         f"{time.perf_counter() - t1:.2f} s: {sparse.bsr.num_tiles} tiles, {sparse.rest.nnz} remainder edges, "
         f"chosen K {sparse.fused.K} / {sparse.fused_t.K}")
    if min(sparse.fused.K, sparse.fused_t.K) <= K2.DEFAULT_K:
        raise AssertionError(f"the sparse graph's plans took K {sparse.fused.K} / {sparse.fused_t.K}")
    out["the sparse graph"] = _k_widths("the sparse graph", sparse, device, gen)
    del sparse
    _log(f"phase k chooser: {time.perf_counter() - t0:.1f} s wall")
    return out


def phase_flash_variants(prep, device) -> dict:
    """The JAX package's ablations of the flash kernels' consumer work on
    the GAT slice's split (ring kernels): K3 with exact and with fast_exp
    exps and K4/K5 likewise (under K6's stats), at H=4 and H=1, F=64; K6 at
    chunk modes full, noscore and off. Each variant is held against its
    plain version at the same flag (K6 noscore on the rows of unsplit runs;
    K3 at fast_exp through ``_check_fast``: its m against the plain version,
    out and l against the kernel's own arithmetic) and the variants of a
    kernel are timed in turns (CUDA events, median of rounds); their
    differences in ms and %."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(12)
    plan = prep.gat_plan
    B, n = plan.B, prep.A.n_cols
    keep = _unsplit_rows(plan.ring.segments, B.tb, B.n_rows)
    rec = {}

    def report(label, ms: dict):
        base = next(iter(ms))
        diffs = ", ".join(f"{k} {v:.4f} ms ({v - ms[base]:+.4f} ms, {100 * (v / ms[base] - 1):+.1f}%)"
                          for k, v in list(ms.items())[1:])
        _log(f"{label}: {base} {ms[base]:.4f} ms, {diffs}")
        rec[label] = ms

    for H in (GAT_HEADS, 1):
        s1, s2, Wh = _scores(n, H, GAT_HIDDEN, gen, device)
        ref = FG.flash_gat_forward_plain(B, s1, s2, Wh, return_stats=True, fast_exp=True)
        err, plain_err, far = _check_fast(
            f"K3 fast_exp at slice shapes H={H}", FG.flash_gat_forward(B, s1, s2, Wh, return_stats=True,
                                                                       fast_exp=True),
            ref, FG.flash_gat_forward(B, s1, s2, Wh), B, FG._takes_ring(B, Wh), s1, s2, Wh)
        del ref
        _log(f"  K3 fast_exp H={H}: max abs err {err:.3g} against the kernel's arithmetic (the exact kernel: "
             f"{far:.3g}; the plain version at fast_exp, a tile's running max: {plain_err:.3g})")
        report(f"K3 at slice shapes H={H} (fast_exp err {err:.3g})", _interleaved_ms({
            "exact": lambda: FG.flash_gat_forward(B, s1, s2, Wh),
            "fast_exp": lambda: FG.flash_gat_forward(B, s1, s2, Wh, fast_exp=True)}, rounds=3))
        for mode in ("noscore", "off"):
            want = FG.flash_gat_hybrid_forward_plain(plan, s1, s2, Wh, _chunk_mode=mode)
            got = FG.flash_gat_hybrid_forward(plan, s1, s2, Wh, _chunk_mode=mode)
            rows = keep if mode == "noscore" else torch.ones_like(keep)
            e = _check(f"K6 {mode} at slice shapes H={H}", got[rows], want[rows], GAT_TOL)
            # noscore: rows whose edges are all chunks keep l = 0, so their sums come out over 1e-30
            _log(f"  K6 {mode} H={H}: max abs err {e:.3g} of max |out| {float(want[rows].abs().max()):.3g}, "
                 f"on {int(rows.sum())} of {rows.numel()} rows")
            del want, got
        report(f"K6 at slice shapes H={H}", _interleaved_ms({
            mode: (lambda mode=mode: FG.flash_gat_hybrid_forward(plan, s1, s2, Wh, _chunk_mode=mode))
            for mode in FG.CHUNK_MODES}, rounds=3))
        _, m, l = FG.flash_gat_hybrid_forward(plan, s1, s2, Wh, return_stats=True)
        gO = torch.randn(Wh.shape, generator=gen, device=device)
        ops = FG.bwd_operands(B, s1, s2, Wh, gO, m, l)
        t = FG.flash_gat_bwd_row_plain(B, **ops, fast_exp=True)
        e4 = max(_check(f"K4 fast_exp at slice shapes H={H}", a, b, GAT_TOL)
                 for a, b in zip(FG.flash_gat_bwd_row(B, **ops, fast_exp=True), t))
        c = FG.flash_gat_bwd_col_plain(B, **ops, t=t[0], fast_exp=True)
        e5 = max(_check(f"K5 fast_exp at slice shapes H={H}", a, b, GAT_TOL)
                 for a, b in zip(FG.flash_gat_bwd_col(B, **ops, t=t[0], fast_exp=True), c))
        del c
        tt = t[0]
        report(f"K4 at slice shapes H={H} (fast_exp err {e4:.3g})", _interleaved_ms({
            "exact": lambda: FG.flash_gat_bwd_row(B, **ops),
            "fast_exp": lambda: FG.flash_gat_bwd_row(B, **ops, fast_exp=True)}, rounds=3))
        report(f"K5 at slice shapes H={H} (fast_exp err {e5:.3g})", _interleaved_ms({
            "exact": lambda: FG.flash_gat_bwd_col(B, **ops, t=tt),
            "fast_exp": lambda: FG.flash_gat_bwd_col(B, **ops, t=tt, fast_exp=True)}, rounds=3))
        del ops, t, tt, m, l, gO, s1, s2, Wh
    _log(f"phase flash variants: {time.perf_counter() - t0:.1f} s wall")
    return rec


def _same_schedule(name, a, b) -> None:
    """Two live schedules hold equal tensors."""
    if a is b:
        return
    pairs = [("step", a.step, b.step), ("rb", a.rb, b.rb)] + [
        (k, v, getattr(b.segments, k)) for k, v in a.segments.tensors().items()]
    for k, x, y in pairs:
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: the padded prep's {k} differs from the unpadded prep's")


def _padded_steps(label, net, pairs, loss_of) -> None:
    """Each (unpadded, padded) prep: its live schedules equal, and one step
    (train mode, dropout from a generator seeded 0, the loop's loss,
    backward) from the same parameters on both, the loss and every gradient
    within 1e-6 of the largest (the same kernels walk the same live steps);
    the step's ms on both (synchronised host clock, median of 3)."""
    dev = next(net.parameters()).device
    ms = {"unpadded": [], "padded": []}
    equal = 0
    for i, (u, p) in enumerate(pairs):
        for f in ("bsr", "bsr_t", "gat_bsr"):
            if getattr(u, f) is not None:
                _same_schedule(f"{label} batch {i} {f}.ring", getattr(u, f).ring, getattr(p, f).ring)
        for f in ("fused", "fused_t"):
            if getattr(u, f) is not None:
                _same_schedule(f"{label} batch {i} {f}.ring", getattr(u, f).ring, getattr(p, f).ring)
        got = []
        for key, prep in (("unpadded", u), ("padded", p)):
            def step():
                net.train()
                net.zero_grad(set_to_none=True)
                loss = loss_of(i, prep, torch.Generator(device=dev).manual_seed(0))
                loss.backward()
                return loss.detach()
            loss = step()
            got.append((loss, {k: q.grad.clone() for k, q in net.named_parameters()}))
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                s = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - s))
            ms[key].append(float(np.median(times)))
        (l0, g0), (l1, g1) = got
        torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-6 * float(l0.abs()),
                                   msg=lambda m: f"{label} batch {i} loss: {m}")
        for k in g0:
            torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-6 * float(g0[k].abs().max()),
                                       msg=lambda m: f"{label} batch {i} grad {k}: {m}")
        equal += bool(torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k]) for k in g0))
    _log(f"{label}: {len(pairs)} padded preps with the unpadded live schedules; steps on them match "
         f"({equal} bit for bit); step ms (forward and backward) median unpadded {np.median(ms['unpadded']):.3f}, "
         f"padded {np.median(ms['padded']):.3f} (by batch: "
         + ", ".join(f"{a:.3f}/{b:.3f}" for a, b in zip(ms["unpadded"], ms["padded"])) + ")")


def phase_padding(device, cfg=PAD_GRAPH) -> dict:
    """Sticky padding (``train/loop._pad_prep_tiles``) where the batch loops
    call it: ``train_node_classifier_sampled`` at prepare="hybrid" on a
    products-density graph (``cfg``; PAD_SEEDS seeds in batches of
    SAMPLED_BATCH, two batches an epoch, 2 epochs: each batch padded to the
    maxima of the batches before it, and some batch must grow) and
    ``train_graph_classifier`` at prepare="bsr" on the molecules (2
    epochs). The loop must pad each batch's prep; every padded
    prep then keeps its unpadded prep's live schedules, and a step on it
    matches the step on the unpadded prep (``_padded_steps``)."""
    t_phase = time.perf_counter()
    data = _products_graph(cfg)
    train = np.nonzero(data.train_mask)[0]
    mask = np.zeros_like(data.train_mask)
    mask[np.random.default_rng(1).choice(train, PAD_SEEDS, replace=False)] = True
    sdata = dataclasses.replace(data, train_mask=mask)
    net = _gcn_net(cfg)
    scfg = SGRACEConfig(num_epochs=2, learning_rate=0.01)
    sampled, preps, pads = [], [], []
    state, hist, launches, per_step, wall = _run_loop(
        "sampled GCN, hybrid, padded", lambda: train_node_classifier_sampled(
            net, sdata, scfg, batch_size=SAMPLED_BATCH, fanouts=(10, 10), seed=0, prepare="hybrid",
            device=device),
        {"make_neighbor_batches": sampled, "_prepare_backend": preps, "_pad_prep_tiles": pads})
    unpadded = [p for _, p, _, _ in preps[1:]]
    padded = [p for _, p, _, _ in pads]
    if len(padded) != len(unpadded) or any(p.kind != "hybrid" or p.fused is None for p in unpadded):
        raise AssertionError(f"sampled loop: {len(padded)} padded preps for {len(unpadded)} batches")
    _want_per_step("sampled GCN, hybrid, padded", per_step, {"bsr_spmm_fused": 4})
    for i, (u, p) in enumerate(zip(unpadded, padded)):
        f, fp = u.fused, p.fused
        _log(f"  sampled batch {i}: tiles {u.bsr.num_tiles} -> {p.bsr.num_tiles}, fused (S, R, K) "
             f"({f.num_steps}, {f.num_chunks}, {f.K}) -> ({fp.num_steps}, {fp.num_chunks}, {fp.K}), fused_t "
             f"({u.fused_t.num_steps}, {u.fused_t.num_chunks}, {u.fused_t.K}) -> ({p.fused_t.num_steps}, "
             f"{p.fused_t.num_chunks}, {p.fused_t.K}); rest dropped: {p.rest is None}")
    # past its own shape (the chunk target keeps one dead chunk past the largest R)
    grew = lambda u, p: (p.bsr.num_tiles > u.bsr.num_tiles or p.fused.num_steps > u.fused.num_steps
                         or p.fused.num_chunks > u.fused.num_chunks + 1
                         or p.fused_t.num_chunks > u.fused_t.num_chunks + 1)
    if len(padded) < 4 or not any(grew(u, p) for u, p in zip(unpadded, padded)):
        raise AssertionError(f"sampled loop: {len(padded)} batches, none padded past its own shape")
    batches = [b for _, bs, _, _ in sampled for b in bs]
    t = lambda a: torch.from_numpy(a).to(device)
    _padded_steps("sampled GCN, hybrid", state.model, list(zip(unpadded, padded)),
                  lambda i, prep, g: _masked_xent(state.model(prep, t(batches[i].x), generator=g),
                                                  t(batches[i].y).long(), t(batches[i].seed_mask).float()))
    out = {k: v for k, v in launches.items() if v}

    graphs = synthetic_molecules(num_graphs=150, seed=4)
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(graphs))
    train_b = make_batches([graphs[i] for i in idx[:120]], 32, rng=rng, pad_to=64)
    test_b = make_batches([graphs[i] for i in idx[120:]], 32, pad_to=64)
    mnet = MoleculeGCN(7, MOL_HIDDEN, 2)
    mnet.load_state_dict({k: torch.from_numpy(v) for k, v in
                          _slice_weights(np.random.default_rng(0), 7, MOL_HIDDEN, 2).items()})
    preps, pads = [], []
    mstate, _, mlaunches, m_per_step, _ = _run_loop(
        "MoleculeGCN, padded", lambda: train_graph_classifier(
            mnet, train_b, test_b, SGRACEConfig(num_epochs=2, learning_rate=0.01), seed=0, prepare="bsr",
            device=device),
        {"_prepare_backend": preps, "_pad_prep_tiles": pads})
    unpadded = [p for _, p, _, _ in preps]
    padded = [p for _, p, _, _ in pads[len(unpadded):]]  # the second pass: every batch at the final maxima
    if len(pads) != 2 * len(unpadded):
        raise AssertionError(f"molecule loop: {len(pads)} padding calls for {len(unpadded)} batches")
    _want_per_step("MoleculeGCN, padded", m_per_step, {"bsr_spmm_fused": 4})
    shapes = {(p.bsr.num_tiles, p.fused.num_steps, p.fused.num_chunks, p.fused.K) for p in padded}
    if len(shapes) != 1:
        raise AssertionError(f"molecule batches padded to several shapes: {shapes}")
    _log(f"  molecule batches: tiles {sorted(p.bsr.num_tiles for p in unpadded)} -> {shapes}")
    _padded_steps("MoleculeGCN, bsr", mstate.model, list(zip(unpadded, padded))[: len(train_b)],
                  lambda i, prep, g: _masked_xent(
                      mstate.model(prep, t(train_b[i].x), t(train_b[i].graph_ids).long(), train_b[i].num_graphs,
                                   generator=g), t(train_b[i].y).long(), t(train_b[i].label_mask).float()))
    _add(out, {k: v for k, v in mlaunches.items() if v})
    _log(f"phase padding: {time.perf_counter() - t_phase:.1f} s wall")
    return out


def main() -> None:
    t_run = time.perf_counter()
    phase_device()
    phase_build()
    device = torch.device("cuda")
    phase_peaks(device)
    phase_kernels_small(device)
    phase_int8_kernels_small(device)
    phase_variant_kernels_small(device)
    phase_fill_ins(device)
    A, data, prep = phase_slice_prepare(device, graph=phase_native_prepare(device))
    rec = phase_kernels_slice(A, prep, device)
    phase_k_chooser(prep, device)
    launches, k2_logits = phase_slice_serve(A, data.x, prep, device)
    # remat: the ReLU layer's aggregation is recomputed, the last layer's is
    # not (its backward reads no output of it), so K2 five times a step
    _log(f"power before the GCN slice's training: {gpu_power_w():.2f} W")
    _add(launches, phase_train(data, prep, _gcn_net(SLICE), device, "GCN slice",
                               {"bsr_spmm_fused": 6}, k1_view=True,
                               remat=(_gcn_net(SLICE, remat=True), {"bsr_spmm_fused": 5}),
                               power=PowerRecorder(gpu_power_w)))
    more_rec, more = phase_variants_agg_slice(A, prep, device, rec["bsr_spmm"]["library_ms"])
    rec.update(more_rec)
    _add(launches, more)
    del prep
    torch.cuda.empty_cache()
    phase_cost_model(device)
    phase_routes(A, device)
    torch.cuda.empty_cache()
    _add(launches, phase_reference_format(device))
    more_rec, more = phase_pallas_slice(A, data, device, k2_logits)
    rec.update(more_rec)
    _add(launches, more)
    torch.cuda.empty_cache()
    more_rec, more = phase_plan_gat_products(device)
    rec.update(more_rec)
    _add(launches, more)
    del k2_logits
    torch.cuda.empty_cache()
    gat_prep = phase_gat_prepare(A, device, "slice", split=SLICE_SPLIT)
    rec.update(phase_gat_kernels_slice(gat_prep, device))
    phase_flash_variants(gat_prep, device)
    dense_part = split_by_tile_density(A, gat_prep.gat_bsr.tb, SLICE_SPLIT[1])[0]
    more_rec, more = phase_subskip(gat_prep.gat_bsr, dense_part, device, "slice's attention", record=True,
                                   plain_min_sb=64)
    rec.update(more_rec)
    _add(launches, more)
    _add(launches, phase_gat_agg(dense_part, gat_prep.gat_bsr, device))
    del dense_part
    _add(launches, {"flash_gat_hybrid_forward": phase_gat_serve(
        A, data.x, gat_prep, device, FG.flash_gat_hybrid_forward, "slice")})
    per_epoch = {"flash_gat_hybrid_forward": 4, "flash_gat_bwd_row": 2, "flash_gat_bwd_col": 2}
    remat = (_gat_net(SLICE, remat=True),
             {"flash_gat_hybrid_forward": 4, "flash_gat_bwd_row": 2, "flash_gat_bwd_col": 2})
    _add(launches, phase_train(data, gat_prep, _gat_net(SLICE), device, "GAT slice", per_epoch, remat=remat))
    phase_gat_layouts(A, gat_prep, device)
    del gat_prep
    torch.cuda.empty_cache()
    _add(launches, phase_gat_small(device))
    rec8, more = phase_int8_hybrid_slice(A, device)
    rec.update(rec8)
    _add(launches, more)
    torch.cuda.empty_cache()
    _add(launches, phase_fake_quant(A, data, device))
    torch.cuda.empty_cache()
    rec7, more = phase_int8_gcn(device)
    rec.update(rec7)
    _add(launches, more)
    torch.cuda.empty_cache()
    _add(launches, phase_int8_gat(device))
    products = _products_graph()
    _add(launches, phase_sampled(device, products))
    _add(launches, phase_padding(device))
    torch.cuda.empty_cache()
    _add(launches, phase_ppi(device))
    torch.cuda.empty_cache()
    _add(launches, phase_molecules(device))
    torch.cuda.empty_cache()
    _add(launches, phase_examples(device))
    torch.cuda.empty_cache()
    _add(launches, phase_dist_gcn(device, products))
    del products
    torch.cuda.empty_cache()
    _add(launches, phase_dist_gat(A, data.x, device))
    del A, data
    torch.cuda.empty_cache()
    _add(launches, phase_dist_dryrun(device))
    sources = {
        "bsr_spmm_fused": ("sgracex1_tpu_torch/csrc/fused_agg_ring.cu", "sgracex1_tpu/ops/fused_agg.py:622"),
        "bsr_spmm": ("sgracex1_tpu_torch/csrc/bsr_spmm_ring.cu", "sgracex1_tpu/ops/bsr.py:589"),
        "flash_gat_forward": ("sgracex1_tpu_torch/csrc/flash_gat_ring.cu", "sgracex1_tpu/ops/flash_gat.py:422"),
        "flash_gat_bwd_row": ("sgracex1_tpu_torch/csrc/flash_gat_bwd_ring.cu", "sgracex1_tpu/ops/flash_gat.py:762"),
        "flash_gat_bwd_col": ("sgracex1_tpu_torch/csrc/flash_gat_bwd_ring.cu", "sgracex1_tpu/ops/flash_gat.py:847"),
        "flash_gat_hybrid_forward": ("sgracex1_tpu_torch/csrc/flash_gat_ring.cu",
                                     "sgracex1_tpu/ops/flash_gat.py:1139"),
        "bsr_spmm_int8": ("sgracex1_tpu_torch/csrc/fused_agg_int8_ring.cu", "sgracex1_tpu/ops/bsr.py:773"),
        "bsr_spmm_int8_fused": ("sgracex1_tpu_torch/csrc/fused_agg_int8_ring.cu",
                                "sgracex1_tpu/ops/fused_agg.py:1054"),
        "spmm_plan": ("sgracex1_tpu_torch/csrc/plan_spmm_gather.cu", "sgracex1_tpu/ops/pallas_spmm.py:232"),
        "bsr_spmm_rowloop": ("sgracex1_tpu_torch/csrc/bsr_spmm_cluster.cu", "sgracex1_tpu/ops/bsr.py:693"),
        "bsr_spmm_fused_k": ("sgracex1_tpu_torch/csrc/fused_agg_ring.cu", "sgracex1_tpu/ops/fused_agg.py:871"),
        "flash_gat_forward_subskip": ("sgracex1_tpu_torch/csrc/flash_gat_ring.cu",
                                      "sgracex1_tpu/ops/flash_gat.py:343"),
        # the plan attention: no TPU kernel of its own (the flash kernels' work
        # on a graph without id locality)
        "plan_gat_fwd_kernel": ("sgracex1_tpu_torch/csrc/plan_gat.cu", None),
        "plan_gat_bwd_rows_kernel": ("sgracex1_tpu_torch/csrc/plan_gat.cu", None),
        "plan_gat_bwd_cols_kernel": ("sgracex1_tpu_torch/csrc/plan_gat.cu", None),
        "merge_split_attention": ("sgracex1_tpu_torch/csrc/plan_rows.cuh", None),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name], **rec[name])
        for name, (src, rep) in sources.items()
    ]
    _log(f"{_card()} (the card again, at the end of the run); run wall {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
