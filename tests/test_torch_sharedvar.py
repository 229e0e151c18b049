"""Port parity: multiverso_tpu_torch.sharedvar.SharedPytree against
multiverso_tpu.sharedvar.SharedPytree.

The flat float32 vector each package's table holds must be equal bit for
bit for the same parameter tree (sorted keys at every level, as
``jax.tree.leaves`` orders a dict), and ``sync`` (Add of current - last,
then Get) is one f32 subtract and one f32 add per element in both, so the
merged trees must agree exactly too.
"""

import jax
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.models import transformer as jtfm
from multiverso_tpu.sharedvar import SharedPytree as JShared
from multiverso_tpu_torch.models import transformer as ttfm
from multiverso_tpu_torch.sharedvar import SharedPytree as TShared
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo


@pytest.fixture(autouse=True)
def _both_runtimes():
    jmv.init()
    tmv.init(device="cpu")
    yield
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _mixed_tree(rng):
    return {
        "zeta": rng.normal(size=(3, 4)).astype(np.float32),
        "alpha": {"w": rng.normal(size=(5,)).astype(np.float32),
                  "b": np.float32(rng.normal()),
                  "deep": {"k": rng.normal(size=(2, 2, 2)).astype(np.float32)}},
        "mid": rng.integers(0, 9, (4,)).astype(np.int32),
    }


def _assert_trees_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_flat_vector_and_sync_match_jax():
    rng = np.random.default_rng(5)
    tree = _mixed_tree(rng)
    js, ts = JShared(tree, name="j"), TShared(tree, name="t")
    np.testing.assert_array_equal(ts.table.get(), js.table.get())
    _assert_trees_equal(ts.get(), js.get())

    local = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(size=np.shape(x)).astype(
            np.float32) * 0.1).astype(np.asarray(x).dtype), tree)
    _assert_trees_equal(ts.sync(local), js.sync(local))
    np.testing.assert_array_equal(ts.table.get(), js.table.get())


def test_transformer_params_flatten_like_jax():
    cfg = jtfm.TransformerConfig(vocab_size=64, dim=32, num_heads=4,
                                 num_layers=2, max_seq=32, attn="flash")
    jparams = jax.tree.map(np.asarray, jtfm.init_params(cfg, seed=0))
    js = JShared(jparams, name="j")
    # numpy tree, torch-tensor tree and nn.Module all flatten the same way
    tcfg = ttfm.TransformerConfig(vocab_size=64, dim=32, num_heads=4,
                                  num_layers=2, max_seq=32)
    model = ttfm.params_from_jax(jparams, tcfg, "cpu")
    tensors = jax.tree.map(lambda a: torch.from_numpy(a.copy()), jparams)
    for src in (jparams, tensors, model):
        ts = TShared(src, name="t")
        np.testing.assert_array_equal(ts.table.get(), js.table.get())
    _assert_trees_equal(ts.get(), js.get())


def test_single_leaf_and_module_sync():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    js, ts = JShared(arr, name="j"), TShared(arr, name="t")
    _assert_trees_equal(ts.get(), js.get())
    _assert_trees_equal(ts.sync(arr * 2), js.sync(arr * 2))

    tcfg = ttfm.TransformerConfig(vocab_size=16, dim=32, num_heads=2,
                                  num_layers=1, max_seq=8,
                                  dtype=torch.bfloat16)
    model = ttfm.params_from_jax(ttfm.init_params(tcfg, 1), tcfg, "cpu")
    shared = TShared(model, name="m")
    merged = shared.sync(model)
    # bf16 leaves come back as float32, exactly
    _assert_trees_equal(merged, ttfm.params_to_numpy(model))
