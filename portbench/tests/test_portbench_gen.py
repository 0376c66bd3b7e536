"""The graph generator, the weights and the refresh."""

import json
import math
import os

import pytest
import torch

from portbench import gen
from portbench.graphs import powerlaw_classes
from portbench.tests.conftest import ROOT


def _cfg(n):
    with open(os.path.join(ROOT, "portbench", "configs", "gcn-products.json")) as f:
        return dict(json.load(f), num_nodes=n)


def _graph(n, seed=1):
    return gen.graph(_cfg(n), seed, "cpu")


@pytest.mark.parametrize("n", [1 << 13, 1 << 15])
def test_node_count_and_mean_degree(n):
    g = _graph(n)
    assert g.num_nodes == n and g.x.shape == (n, 100) and g.y.shape == (n,)
    deg = g.edges.shape[1] / n
    assert 50.5 * (1 - powerlaw_classes.SHORT) <= deg < 50.5, deg


@pytest.mark.parametrize("n", [1 << 13, 1 << 15])
def test_the_tail_carries_the_degree_without_collapsing_onto_hubs(n):
    g = _graph(n)
    r, c = g.edges
    deg = torch.bincount(r, minlength=n)
    band = float((((r - c) % n) <= 1).double().mean()) * 2  # the ring of 1, both ways
    assert band < 0.05, band
    cap = math.sqrt(n * 50.5)
    assert 0.4 * cap < int(deg.max()) <= cap  # a heavy tail, capped
    assert int(deg.min()) >= 2  # the ring keeps every node connected
    hub = int(torch.argmax(deg))
    assert hub not in (0, n - 1) or int(deg[0]) < cap  # ranks go to random ids
    assert 0.6 < float((g.y[r] == g.y[c]).double().mean()) < 0.85  # in-class draws


def test_expected_degrees_follow_the_cap_and_mean():
    w = powerlaw_classes.expected_degrees(1 << 14, 48.5, 2.5, 900.0, "cpu")
    assert float(w.mean()) == pytest.approx(48.5)
    assert float(w.max()) == pytest.approx(900.0, rel=1e-6)
    assert torch.all(w[1:] <= w[:-1])


def test_edges_are_undirected_sorted_and_loop_free():
    n = 1 << 12
    g = _graph(n)
    r, c = g.edges
    assert torch.all(r != c)
    key = r * n + c
    assert torch.all(key[1:] > key[:-1])  # sorted, no duplicate
    assert torch.equal(torch.sort(c * n + r).values, key)  # every edge both ways
    assert int(g.y.max()) < 47


def test_split_is_a_partition_of_60_20_20():
    n = 1 << 12
    g = _graph(n)
    m = torch.stack([g.train_mask, g.val_mask, g.test_mask]).int()
    assert torch.all(m.sum(0) == 1)
    assert m.sum(1).tolist() == [int(n * 0.6), int(n * 0.8) - int(n * 0.6), n - int(n * 0.8)]


def test_same_seed_same_graph_other_seed_other_graph():
    a, b, c = _graph(1 << 12, 5), _graph(1 << 12, 5), _graph(1 << 12, 6)
    assert torch.equal(a.edges, b.edges) and torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert not torch.equal(a.x, c.x) and not torch.equal(a.edges, c.edges)


def test_a_large_seed_is_taken():
    g = _graph(1 << 12, 2**31 + 12345)
    assert g.num_nodes == 1 << 12


def test_weights_keep_their_bounds_and_seed():
    leaves = [("a", (3, 4), 0.5), ("b", (7,), 2.0)]
    w = gen.weights(leaves, 9, "cpu")
    assert w["a"].shape == (3, 4) and w["b"].shape == (7,)
    assert float(w["a"].abs().max()) <= 0.5 and float(w["b"].abs().max()) <= 2.0
    assert torch.equal(w["a"], gen.weights(leaves, 9, "cpu")["a"])


def test_refresh_overwrites_one_share_of_the_rows():
    x = torch.zeros(1000, 4)
    gen.refresh(x, 0.01, 7)
    changed = (x != 0).any(1)
    assert int(changed.sum()) == 10
    y = torch.zeros(1000, 4)
    gen.refresh(y, 0.01, 7)
    assert torch.equal(x, y)
