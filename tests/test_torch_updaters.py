"""Port parity: multiverso_tpu_torch.updaters against multiverso_tpu.updaters.

The same numpy rows, state, delta and AddOption go through the JAX updater
and its torch port for three successive applies. Tolerances: default and
sgd are a single IEEE add/sub, so they must agree exactly; momentum,
adagrad, adam and ftrl agree to rtol 1e-6 / atol 1e-6 (f32), the margin
for the few-ulp differences of sqrt and pow between XLA's CPU backend and
PyTorch's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu import updaters as jup
from multiverso_tpu_torch import updaters as tup

SHAPE = (17, 5)
# leaves that the math keeps non-negative
_NONNEG = {"g_sqr", "v", "n"}

CASES = [
    ("default", {}, 1),
    ("sgd", {}, 1),
    ("momentum_sgd", {}, 1),
    ("adagrad", {}, 1),
    ("adagrad", {"per_worker": True}, 3),
    ("adam", {}, 1),
    ("ftrl", {}, 1),
]


def _random_state(jstate, rng):
    """Random values for every float leaf; adam's step counter random too."""
    out = {}
    for key, leaf in dict(jstate).items():
        shape = np.shape(leaf)
        if key == "t":
            out[key] = np.asarray(rng.integers(0, 7), np.int32)
        elif key in _NONNEG:
            out[key] = rng.uniform(0.0, 2.0, shape).astype(np.float32)
        else:
            out[key] = rng.normal(0.0, 1.0, shape).astype(np.float32)
    return out


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}{'-per_worker' if c[1] else ''}"
                              for c in CASES])
def test_updater_matches_jax(case):
    name, kwargs, workers = CASES[case]
    rng = np.random.default_rng(case)
    ju = jup.get_updater(name, num_workers=workers, **kwargs)
    tu = tup.get_updater(name, num_workers=workers, **kwargs)
    assert type(ju).__name__ == type(tu).__name__

    data = rng.normal(0.0, 1.0, SHAPE).astype(np.float32)
    state = _random_state(ju.init_state(SHAPE, jnp.float32), rng)
    tstate0 = tu.init_state(SHAPE, torch.float32, torch.device("cpu"))
    assert sorted(tstate0) == sorted(state)
    for key, leaf in tstate0.items():
        assert tuple(leaf.shape) == state[key].shape

    jd, js = jnp.asarray(data), {k: jnp.asarray(v) for k, v in state.items()}
    td = torch.from_numpy(data.copy())
    ts = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    if not state:
        js = ju.init_state(SHAPE, jnp.float32)
    for step in range(3):
        delta = (rng.normal(0.0, 1.0, SHAPE) * 0.1).astype(np.float32)
        opt = (int(step % workers), float(rng.uniform(0.5, 0.95)),
               float(rng.uniform(0.01, 0.5)), float(rng.uniform(0.05, 0.5)),
               0.0)
        jd, js = ju.apply(jd, js, jnp.asarray(delta), jup.AddOption(*opt))
        td2, ts2 = tu.apply(td, ts, torch.from_numpy(delta),
                            tup.AddOption(*opt))
        assert td2 is td and ts2 is ts   # in place
        if name in ("default", "sgd"):
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        else:
            np.testing.assert_allclose(td.numpy(), np.asarray(jd),
                                       rtol=1e-6, atol=1e-6)
        for key in state:
            if key == "t":
                assert int(ts[key]) == int(js[key])
            else:
                np.testing.assert_allclose(ts[key].numpy(),
                                           np.asarray(js[key]),
                                           rtol=1e-6, atol=1e-6)


def test_adam_step_counts_apply_calls():
    tu = tup.get_updater("adam")
    data = torch.zeros(4)
    state = tu.init_state((4,), torch.float32, torch.device("cpu"))
    for i in range(1, 4):
        tu.apply(data, state, torch.ones(4), tup.AddOption())
        assert int(state["t"]) == i
        assert state["t"].dtype == torch.int32


def test_registry_and_integer_tables():
    for dt in (np.int32, torch.int64, "int32"):
        assert type(tup.get_updater("adam", dtype=dt)) is tup.Updater
    assert type(tup.get_updater("adam", dtype=torch.float32)) is tup.AdamUpdater
    with pytest.raises(ValueError, match="unknown updater_type"):
        tup.get_updater("nope")
    with pytest.raises(ValueError):
        jup.get_updater("nope")

    class Mine(tup.SGDUpdater):
        name = "mine"
    builtin = {"default", "sgd", "momentum_sgd", "adagrad", "adam", "ftrl"}
    assert set(tup._REGISTRY) == builtin and builtin <= set(jup._REGISTRY)
    tup.register_updater("mine_test", Mine)
    try:
        assert type(tup.get_updater("mine_test")) is Mine
    finally:
        del tup._REGISTRY["mine_test"]


def test_classification_sets_match_jax():
    names = lambda s: sorted(c.__name__ for c in s)
    assert names(tup.STATELESS_LINEAR) == names(jup.STATELESS_LINEAR)
    assert {c.__name__: v for c, v in tup.STATELESS_LINEAR.items()} == \
        {c.__name__: v for c, v in jup.STATELESS_LINEAR.items()}
    assert names(tup.OPT_INSENSITIVE) == names(jup.OPT_INSENSITIVE)
    assert names(tup.ROW_LOCAL_STATE) == names(jup.ROW_LOCAL_STATE)
    assert tup.AddOption._fields == jup.AddOption._fields
    assert tup.AddOption() == tuple(jup.AddOption())
