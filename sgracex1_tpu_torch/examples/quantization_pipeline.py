"""End-to-end quantization pipeline: float training, calibration from the
trained model's activation ranges, QAT fine-tuning, and the full-integer
int8 freeze, dense and on int8 tiles (K7).

    python -m sgracex1_tpu_torch.examples.quantization_pipeline [--qbits 8|4|2|1] [--epochs 60] [--device cpu]

1. train a float 2-layer GCN;
2. calibrate the quantization constants from its observed ranges;
3. fine-tune with fake-quant QAT at the chosen bit width;
4. freeze to the int8 inference form and compare float, QAT and int8
   accuracy; then the same freeze on sparse int8 tiles (tb 128).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sgracex1_tpu_torch._device import resolve_device
from sgracex1_tpu_torch.config import SGRACEConfig
from sgracex1_tpu_torch.graph.datasets import sbm_node_classification
from sgracex1_tpu_torch.graph.normalize import sym_norm
from sgracex1_tpu_torch.nn.models import GCNModel
from sgracex1_tpu_torch.ops.dispatch import prepare_adjacency
from sgracex1_tpu_torch.quant import int8 as qi8
from sgracex1_tpu_torch.quant.autocal import calibrate
from sgracex1_tpu_torch.train.loop import train_node_classifier


def accuracy(logits: np.ndarray, y: np.ndarray, mask: np.ndarray) -> float:
    return float(((np.argmax(logits, -1) == y) * mask).sum() / mask.sum())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qbits", type=int, default=8, choices=[1, 2, 4, 8])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--nodes", type=int, default=600)
    ap.add_argument("--device", default=None, help="cpu, or the CUDA card (default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    data = sbm_node_classification(n=args.nodes, num_classes=4, seed=0)
    A = sym_norm(data.edge_index, data.num_nodes)
    x = torch.from_numpy(data.x).to(device)
    kw = dict(num_features=data.num_features, hidden_channels=32, num_classes=data.num_classes)

    # 1. float training
    model_f = GCNModel(**kw, generator=torch.Generator().manual_seed(0))
    _, hist_f = train_node_classifier(model_f, data, SGRACEConfig(num_epochs=args.epochs, learning_rate=0.01),
                                      device=device)
    print(f"float best test acc:  {hist_f.best_test_acc:.4f}")

    # 2. calibration from the trained model's activation ranges
    model_f.load_state_dict(hist_f.best_params)
    cal = calibrate(model_f.eval(), prepare_adjacency(A, device=device), x, qbits=args.qbits)
    print(f"calibrated ({args.qbits}-bit): f_max={cal.raw['f_max']:.3f} w_max={cal.raw['w_max']:.3f} "
          f"w_max2={cal.raw['w_max2']:.3f}")

    # 3. QAT fine-tune at the target bit width
    model_q = GCNModel(**kw, calibration=cal, generator=torch.Generator().manual_seed(0))
    _, hist_q = train_node_classifier(model_q, data, SGRACEConfig(num_epochs=args.epochs, w_qbits=args.qbits),
                                      device=device)
    print(f"QAT  best test acc:   {hist_q.best_test_acc:.4f}")

    # 4. int8 freeze (the 8-bit integer pipeline whatever the QAT width: the
    #    integer grids of narrower models embed in int8 exactly); the linear
    #    head stays float, as the reference's
    p = hist_q.best_params
    W1, W2 = (p[f"conv{i}.weight"].numpy() for i in (1, 2))
    Wo, bo = p["head.weight"].numpy(), p["head.bias"].numpy()
    A_dense = A.to_dense().astype(np.float32)
    am = qi8.collect_amax_gcn2(A_dense, data.x, W1, W2)
    xs = qi8.quantize_unsigned_shifted(x, cal.features)
    net = qi8.freeze_gcn2(W1, W2, A_dense, cal, **am, device=device)
    logits = qi8.int8_gcn2_forward(net, xs).cpu().numpy() @ Wo.T + bo
    acc = accuracy(logits, data.y, data.test_mask)
    print(f"int8 frozen test acc: {acc:.4f}")

    # 5. the same freeze on sparse int8 tiles (no dense N x N): K7
    net_s = qi8.freeze_gcn2_sparse(W1, W2, A, cal, tb=128, **am, device=device)
    hidden_s = qi8.int8_gcn2_sparse_forward(net_s, xs).cpu().numpy()[: data.num_nodes]
    acc_s = accuracy(hidden_s @ Wo.T + bo, data.y, data.test_mask)
    print(f"int8 sparse-tile test acc: {acc_s:.4f}")
    return dict(float=hist_f.best_test_acc, qat=hist_q.best_test_acc, int8=acc, int8_sparse=acc_s)


if __name__ == "__main__":
    main()
