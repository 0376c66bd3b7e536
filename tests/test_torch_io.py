"""sgracex1_tpu_torch.graph.io against sgracex1_tpu.graph.io on files the
tests write: the native and the numpy parse of each package give the
identical matrices (rows, cols, vals, shape, nnz), and a missing file
raises in both."""

import numpy as np
import pytest
import torch

from sgracex1_tpu.graph import io as j_io
from sgracex1_tpu.runtime import native as j_native
from sgracex1_tpu_torch.graph import io as t_io
from sgracex1_tpu_torch.runtime import native

torch.set_num_threads(1)


def _same_matrix(a, b):
    for k in ("rows", "cols", "vals"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.shape == b.shape and a.nnz == b.nnz


def _parses(monkeypatch, fn_t, fn_j, *args):
    """(port native, port numpy, JAX native, JAX numpy) results."""
    assert native.available() and j_native.available()
    out = [fn_t(*args)]
    with native.disabled():
        out.append(fn_t(*args))
    out.append(fn_j(*args))
    with monkeypatch.context() as m:
        # the JAX get_lib returns a loaded library before it reads
        # SGRACE_NATIVE, so its numpy path is reached as unavailable
        m.setattr(j_native, "_lib", None)
        m.setattr(j_native, "_tried", True)
        assert not j_native.available()
        out.append(fn_j(*args))
    return out


def _csr_text(rng, n_rows, n_cols, nnz_row, values=True):
    deg = np.minimum(rng.integers(0, nnz_row * 2, n_rows), n_cols)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    cols = np.concatenate([np.sort(rng.choice(n_cols, d, replace=False)) for d in deg])
    lines = [",".join(map(str, rowptr)) + ",", ",".join(map(str, cols)) + ","]
    if values:
        vals = rng.uniform(0.01, 2.0, len(cols)).astype(np.float32)
        lines.append(",".join(repr(float(v)) for v in vals) + ",")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("values", [True, False])
def test_csr_text_matches_jax(tmp_path, monkeypatch, values):
    p = tmp_path / "a.txt"
    p.write_text(_csr_text(np.random.default_rng(0), 300, 250, 6, values))
    a, b, c, d = _parses(monkeypatch, t_io.load_csr_text, j_io.load_csr_text, str(p))
    for x in (b, c, d):
        _same_matrix(a, x)
    if not values:
        assert (np.asarray(a.vals)[: a.nnz] == 1.0).all()
    wide = t_io.load_csr_text(str(p), 400, pad_to=64)
    _same_matrix(wide, j_io.load_csr_text(str(p), 400, pad_to=64))
    assert wide.shape == (300, 400) and wide.e_pad % 64 == 0


@pytest.mark.parametrize("text", ["0,1,3\n0,1,2\n", "0,1,3\n0,1,2\n0.5\n", "0,2,2,3\n1,0,2\n4,5,6,7,8\n"])
def test_csr_text_missing_and_truncated_values(tmp_path, monkeypatch, text):
    """No values line (all 1.0), a truncated one (padded with 1.0) and a
    long one (cut to rowPtr's count): the same matrix on every path."""
    p = tmp_path / "m.txt"
    p.write_text(text)
    a, *others = _parses(monkeypatch, t_io.load_csr_text, j_io.load_csr_text, str(p))
    for x in others:
        _same_matrix(a, x)


def test_dense_text_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((40, 16)).astype(np.float32)
    p = tmp_path / "w.txt"
    p.write_text("\n".join(",".join(repr(float(v)) for v in row) for row in w) + "\n6,7\n")
    outs = _parses(monkeypatch, t_io.load_dense_text, j_io.load_dense_text, str(p))
    for x in outs:
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, outs[0])
    np.testing.assert_array_equal(outs[0][:40], w)
    np.testing.assert_array_equal(outs[0][40], [6, 7] + [0] * 14)


def _write_dataset(d, name, rng, feat=True, hidden=8):
    desc = t_io.REFERENCE_DATASETS[name]
    n, m = desc["N_adj"], desc["M_fea"]
    (d / f"{name}_adj.txt").write_text(_csr_text(rng, n, n, 3))
    if feat:
        (d / f"{name}_feat.txt").write_text(_csr_text(rng, n, m, 2, values=False))
    w = rng.standard_normal((m, hidden)).astype(np.float32)
    (d / f"{name}_weights.txt").write_text("\n".join(",".join(repr(float(v)) for v in r) for r in w) + "\n")
    return w


@pytest.mark.parametrize("name,feat", [("mol", True), ("cora", False)])
def test_reference_dataset_matches_jax(tmp_path, monkeypatch, name, feat):
    """``load_reference_dataset`` on files written at the descriptor's
    shape (with the feature file, and without it: then both packages draw
    the same binary features from ``default_rng(0)``); the directory
    comes from ``data_dir`` or from ``SGRACE_DATA_DIR``."""
    w = _write_dataset(tmp_path, name, np.random.default_rng(2), feat)
    adj, fea, wt = t_io.load_reference_dataset(name, str(tmp_path))
    ja, jf, jw = j_io.load_reference_dataset(name, str(tmp_path))
    _same_matrix(adj, ja)
    _same_matrix(fea, jf)
    np.testing.assert_array_equal(wt, jw)
    np.testing.assert_array_equal(wt, w)
    desc = t_io.REFERENCE_DATASETS[name]
    assert adj.shape == (desc["N_adj"],) * 2 and fea.shape == (desc["N_adj"], desc["M_fea"])
    if not feat:
        assert fea.nnz == desc["NNZ_fea"]
    monkeypatch.setenv("SGRACE_DATA_DIR", str(tmp_path))
    assert t_io.reference_data_dir() == str(tmp_path) == j_io.reference_data_dir()
    _same_matrix(t_io.load_reference_dataset(name)[0], adj)


def test_missing_files_raise(tmp_path, monkeypatch):
    missing = str(tmp_path / "none.txt")
    for fn in (t_io.load_csr_text, t_io.load_dense_text, j_io.load_csr_text, j_io.load_dense_text):
        with pytest.raises(FileNotFoundError):
            fn(missing)
    with pytest.raises(FileNotFoundError):
        t_io.load_reference_dataset("mol", str(tmp_path))
    monkeypatch.delenv("SGRACE_DATA_DIR", raising=False)
    monkeypatch.setattr(t_io, "reference_data_dir", lambda: None)
    with pytest.raises(FileNotFoundError):
        t_io.load_reference_dataset("mol")
    with pytest.raises(KeyError):
        t_io.load_reference_dataset("unknown", str(tmp_path))
