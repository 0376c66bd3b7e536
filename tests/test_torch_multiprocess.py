"""Two real processes joined by torch.distributed (gloo, on the CPU), one
halo GCN layer forward and backward over the process-group mesh (S = 2,
one shard a rank), against the in-process mesh of the same two shards.

The all_to_all of the halo exchange crosses the process boundary, and so
does its transpose in the backward and the sum of W's gradient over the
ranks. Run as a script, this file is the worker:
``python tests/test_torch_multiprocess.py RANK PORT OUT_DIR``."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

RANKS = 2
TIMEOUT_S = 120  # each worker: interpreter and torch start-up, a 96-node layer


def _problem():
    """The same graph, features and weight in every process."""
    from sgracex1_tpu_torch.graph.normalize import sym_norm
    from sgracex1_tpu_torch.parallel.halo import build_halo
    from sgracex1_tpu_torch.parallel.partition import pad_nodes

    rng = np.random.default_rng(0)
    n, f, h = 96, 12, 8
    ei = np.unique(np.stack([rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)]), axis=1)
    G, n_pad = build_halo(sym_norm(ei, n), RANKS, device="cpu")
    X = pad_nodes(rng.standard_normal((n, f)).astype(np.float32), n_pad)
    W = (rng.standard_normal((f, h)) * 0.3).astype(np.float32)
    return G, X, W


def _layer(mesh, G, X, W):
    """Forward and backward of one halo GCN layer; (out, grad x, grad W)."""
    from sgracex1_tpu_torch.parallel.halo import dist_gnn_layer_halo

    x = torch.tensor(X, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    out = dist_gnn_layer_halo(mesh, G, x, w, relu=True)
    torch.sum(out ** 2).backward()
    return out.detach().numpy(), x.grad.numpy(), w.grad.numpy()


def _worker(rank: int, port: str, out_dir: str) -> None:
    import torch.distributed as dist

    from sgracex1_tpu_torch.parallel.mesh import global_mesh, init_multihost

    torch.set_num_threads(1)
    init_multihost(f"127.0.0.1:{port}", RANKS, rank, device="cpu")
    try:
        mesh = global_mesh()
        assert mesh.n_shards == RANKS and mesh.local_shards == [rank] and not mesh.in_process
        G, X, W = _problem()
        nl = G.n_local
        out, gx, gw = _layer(mesh, G, X[rank * nl : (rank + 1) * nl], W)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), out=out, gx=gx, gw=gw)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_halo_gcn_matches_in_process(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = str(_free_port())
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), port, str(tmp_path)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"

    from sgracex1_tpu_torch.parallel.mesh import make_mesh

    G, X, W = _problem()
    want = _layer(make_mesh(RANKS, device="cpu"), G, X, W)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(RANKS)]
    for i, name in enumerate(("out", "gx")):
        np.testing.assert_allclose(np.concatenate([g[name] for g in got]), want[i], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for g in got:  # W's gradient summed over the ranks, the same on each
        np.testing.assert_allclose(g["gw"], want[2], rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
