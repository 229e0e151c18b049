"""Port parity, ``tables/sparse_matrix_table.py``: the stale-row protocol
of multiverso_tpu_torch's SparseMatrixTable against multiverso_tpu's over
one scripted sequence of sparse Gets and Adds for 2 workers (the same
rows bit for bit, the same stale fractions), its ``_RowCache``, the
``MatrixTable._rows_applied`` hook it stands on, and ROADMAP C.8 (``load``
and ``adopt`` leave the dirty bits as they were) pinned in both packages.

The JAX side runs on a one-device CPU mesh, where both packages pad the
table to rows + 1. Row adds are summed on the host in float64 in both
packages, so every comparison is exact but FTRL's (rtol 1e-6).
"""

import io

import jax
import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.tables.sparse_matrix_table import (
    SparseMatrixTable as JSparse, _RowCache as JRowCache)
from multiverso_tpu_torch.tables.matrix_table import MatrixTable
from multiverso_tpu_torch.tables.sparse_matrix_table import (
    SparseMatrixTable, SparseMatrixTableOption, _RowCache)
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

ROWS, COLS = 20, 3


@pytest.fixture(autouse=True)
def _both_runtimes():
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))
    tmv.init(device="cpu")
    yield
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _pair(updater, init):
    return (JSparse(ROWS, COLS, updater=updater, init=init, num_workers=2,
                    name="s"),
            SparseMatrixTable(ROWS, COLS, updater=updater, init=init,
                              num_workers=2, name="s"))


def _same(t_rows, j_rows, updater):
    if updater == "ftrl":
        # FTRL's sqrt and division differ by a few ulp between XLA's CPU
        # backend and torch (tests/test_torch_updaters.py): rtol 1e-6
        np.testing.assert_allclose(t_rows, j_rows, rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(t_rows, j_rows)


@pytest.mark.parametrize("updater", ["default", "sgd", "ftrl"])
def test_stale_protocol_matches_jax(updater):
    rng = np.random.default_rng(0)
    init = rng.normal(size=(ROWS, COLS)).astype(np.float32)
    j, t = _pair(updater, init)

    def vals(n):
        return rng.normal(size=(n, COLS)).astype(np.float32)

    script = [
        ("get", [0, 1, 2, 2, 7], 0),
        ("get", [0, 1, 2], 0),                 # all fresh for worker 0
        ("get", [2, 7, 19], 1),                # worker 1's first pulls
        ("add_rows", [1, 3, 3, 7], vals(4)),   # duplicates sum in float64
        ("get", [0, 1, 2, 3, 7], 0),
        ("get", [1, 1, 19], 1),
        ("add_async", None, rng.normal(size=(ROWS, COLS)
                                       ).astype(np.float32)),
        ("get", [4, 5], 0),
        ("get", [0, 1, 2, 3, 7], 0),
        ("add_rows", [19, 0], vals(2)),
        ("get", [0, 19, 19, 2], 1),
        ("get", list(range(ROWS)), 0),
    ]
    fracs = []
    for op, ids, arg in script:
        if op == "get":
            fj = j.stale_fraction(ids, arg)
            ft = t.stale_fraction(ids, arg)
            fracs.append(ft)
            assert ft == fj, (op, ids, arg)
            _same(t.get_rows_sparse(ids, arg), j.get_rows_sparse(ids, arg),
                  updater)
        elif op == "add_rows":
            j.add_rows(ids, arg)
            t.add_rows(ids, arg)
        else:
            j.add_async(arg)
            t.add_async(arg)
    # the protocol did skip fresh rows, and pulled stale ones
    assert 0.0 in fracs and 1.0 in fracs and any(0 < f < 1 for f in fracs)
    _same(t.get(), j.get(), updater)
    assert t.stale_fraction([], 0) == j.stale_fraction([], 0) == 0.0
    assert t.cache_nbytes(0) == j.cache_nbytes(0)
    for bad in (2, -1):
        for table in (j, t):
            with pytest.raises(IndexError, match="worker_id"):
                table.get_rows_sparse([0], bad)


def test_option_builds_the_table():
    t = tmv.create_table(SparseMatrixTableOption(5, 2, num_workers=3))
    assert isinstance(t, SparseMatrixTable)
    assert t._dirty.shape == (3, t.padded_shape[0])
    assert bool(t._dirty.all())


def test_row_cache_matches_jax():
    rng = np.random.default_rng(1)
    caches = (JRowCache(4, np.float32), _RowCache(4, np.float32))
    for _ in range(6):
        ids = rng.choice(100, rng.integers(1, 30), replace=False)
        rows = rng.normal(size=(ids.size, 4)).astype(np.float32)
        for c in caches:
            c.put(ids, rows)
        ask = rng.choice(ids, 40)
        assert np.array_equal(caches[1].take(ask), caches[0].take(ask))
        assert caches[1].nbytes == caches[0].nbytes
    missing = np.setdiff1d(np.arange(101), caches[1]._keys)[:1]
    for c in caches:
        with pytest.raises(KeyError, match="not cached"):
            c.take(missing)


def test_rows_applied_sees_deduplicated_ids():
    seen = []

    class Probe(MatrixTable):
        def _rows_applied(self, ids, dev_ids):
            seen.append((ids.tolist(), dev_ids.tolist()))

    t = Probe(10, 2, updater="sgd")
    t.add_rows([5, 1, 5, 3], np.ones((4, 2), np.float32))
    t.add_rows(np.array([9]), np.ones((1, 2), np.float32))
    assert seen == [([1, 3, 5], [1, 3, 5]), ([9], [9])]
    assert t.get_rows([5])[0].tolist() == [-2.0, -2.0]


@pytest.mark.parametrize("write", ["load", "adopt"])
def test_load_and_adopt_keep_the_dirty_bits(write):
    """ROADMAP C.8, in both packages: after a worker's sparse Get, a load
    (or adopt) of other values leaves that worker's bits clear, so its
    next sparse Get serves the rows from before the write; get_rows reads
    the table."""
    ids = [0, 3, 4]
    for table in _pair("default", None):
        before = table.get_rows_sparse(ids, 0).copy()
        assert np.array_equal(before, np.zeros((3, COLS), np.float32))
        if write == "load":
            src = type(table)(ROWS, COLS, init=-np.ones((ROWS, COLS),
                                                        np.float32),
                              num_workers=2, name="src")
            buf = io.BytesIO()
            src.store(buf)
            buf.seek(0)
            table.load(buf)
        else:
            state = table.state
            table.adopt({"data": state["data"] - 1,
                         "ustate": state["ustate"]})
        assert table.stale_fraction(ids, 0) == 0.0
        assert np.array_equal(table.get_rows_sparse(ids, 0), before)
        assert np.array_equal(table.get_rows(ids),
                              -np.ones((3, COLS), np.float32))
        # worker 1 never pulled: it reads the written rows
        assert np.array_equal(table.get_rows_sparse(ids, 1),
                              -np.ones((3, COLS), np.float32))
