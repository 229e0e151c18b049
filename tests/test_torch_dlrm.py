"""Port parity, ``models/dlrm.py``: the port's DLRM against the JAX
package's on the same numpy inputs, at the JAX tests' small configs and
at the serving bench's (tests/test_dlrm.py, tools/bench_serving.py).

Tolerances (f32 on the CPU, the JAX side under
``jax.default_matmul_precision("float32")``): logits, loss and every
gradient within 1e-5 of the reference's max |x| (measured: ~1e-7);
``make_train_step`` tables within 1e-5 of max |x| after 4 steps; the
seeded draws (``init_mlp_params``, ``synthetic_ctr``) and the flat
layout bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
from multiverso_tpu.models import dlrm as jd
from multiverso_tpu.updaters import AddOption as JAddOption
import multiverso_tpu_torch as tmv
from multiverso_tpu_torch.models import dlrm as td
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.zoo import Zoo as TZoo

RTOL = 1e-5
CONFIGS = {
    "small": dict(vocab_sizes=(40, 40, 20), embed_dim=8, dense_dim=4,
                  bottom_mlp=(16, 8), top_mlp=(16, 1)),
    "one_layer": dict(vocab_sizes=(8, 8), embed_dim=4, dense_dim=2,
                      bottom_mlp=(4,), top_mlp=(4, 1)),
    "serving": dict(vocab_sizes=(4096, 1024, 256, 64), embed_dim=16,
                    dense_dim=8, bottom_mlp=(32, 16), top_mlp=(16, 1)),
}


def _cfgs(name):
    return jd.DLRMConfig(**CONFIGS[name]), td.DLRMConfig(**CONFIGS[name])


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.fixture(autouse=True)
def _runtimes():
    yield
    if jmv.Zoo.get().started:
        jmv.shutdown()
    if TZoo.get().started:
        TZoo.get().stop()


def _inputs(jc, b=64, seed=1):
    cat, dense, labels = jd.synthetic_ctr(jc, b, seed=seed)
    rows = np.random.default_rng(seed).normal(
        0, 0.05, (b, len(jc.vocab_sizes), jc.embed_dim)).astype(np.float32)
    return cat, dense, labels, rows


@pytest.mark.parametrize("name", list(CONFIGS))
def test_seeded_draws_and_flat_layout_match(name):
    jc, tc = _cfgs(name)
    jf, jmeta = jd.flatten_mlp(jd.init_mlp_params(jc, 3))
    tp = td.init_mlp_params(tc, 3)
    tf, tmeta = td.flatten_mlp(tp)
    np.testing.assert_array_equal(tf, jf)
    assert tmeta[1] == [tuple(s) for s in jmeta[1]]
    # unflatten gives views into the flat vector, the same leaves back
    back = td.unflatten_mlp(torch.from_numpy(tf), tmeta)
    for k in td._KEYS:
        for a, b in zip(back[k], tp[k]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    for got, want in zip(td.synthetic_ctr(tc, 300, seed=4),
                         jd.synthetic_ctr(jc, 300, seed=4)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(td.field_offsets(tc),
                                  jd.field_offsets(jc))
    assert td.total_rows(tc) == jd.total_rows(jc)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_loss_and_gradients_match_jax(name):
    jc, tc = _cfgs(name)
    jp = jd.init_mlp_params(jc, 2)
    tp = td.mlp_from_jax(jp)   # the JAX weights carried across
    cat, dense, labels, rows = _inputs(jc)
    with jax.default_matmul_precision("float32"):
        jlog = jd.forward(jp, jnp.asarray(rows), jnp.asarray(dense), jc)
        jl, (jg, jr) = jax.value_and_grad(jd.loss_fn, argnums=(0, 1))(
            jp, jnp.asarray(rows), jnp.asarray(dense),
            jnp.asarray(labels), jc)
    t_rows, t_dense = torch.from_numpy(rows), torch.from_numpy(dense)
    t_labels = torch.from_numpy(labels)
    _close(td.forward(tp, t_rows, t_dense, tc).numpy(), jlog)
    _close(td.loss_fn(tp, t_rows, t_dense, t_labels, tc).item(), jl)
    tl, tg, tr = td.loss_and_grads(tp, t_rows, t_dense, t_labels, tc)
    _close(tl.item(), jl)
    _close(tr.numpy(), jr)
    for k in td._KEYS:
        assert len(tg[k]) == len(jg[k])
        for a, b in zip(tg[k], jg[k]):
            _close(a.numpy(), b)


def test_mlp_from_jax_gives_the_same_loss():
    jc, tc = _cfgs("serving")
    jp = jd.init_mlp_params(jc, 9)
    cat, dense, labels, rows = _inputs(jc, b=32, seed=5)
    with jax.default_matmul_precision("float32"):
        jl = float(jd.loss_fn(jp, jnp.asarray(rows), jnp.asarray(dense),
                              jnp.asarray(labels), jc))
    tl = td.loss_fn(td.mlp_from_jax(jp), torch.from_numpy(rows),
                    torch.from_numpy(dense), torch.from_numpy(labels),
                    tc).item()
    assert abs(tl - jl) <= RTOL * abs(jl)


def _jax_tables(jc, updater, seed):
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))
    emb = jmv.MatrixTable(jd.total_rows(jc), jc.embed_dim, updater=updater,
                          seed=seed, init_scale=0.05, name="dlrm_emb")
    flat, meta = jd.flatten_mlp(jd.init_mlp_params(jc, seed))
    mlp = jmv.ArrayTable(flat.size, updater=updater, init=flat,
                         name="dlrm_mlp")
    return emb, mlp, meta


def _port_tables(tc, updater, emb_init, seed):
    tmv.init(device="cpu")
    emb = tmv.MatrixTable(td.total_rows(tc), tc.embed_dim, updater=updater,
                          init=emb_init, name="dlrm_emb")
    flat, meta = td.flatten_mlp(td.init_mlp_params(tc, seed))
    mlp = tmv.ArrayTable(flat.size, updater=updater, init=flat,
                         name="dlrm_mlp")
    return emb, mlp, meta


@pytest.mark.parametrize("updater", ["adagrad", "default"])
@pytest.mark.parametrize("name", ["small", "serving"])
def test_make_train_step_matches_jax(name, updater):
    """4 steps of the fused PS step from one start: the loss and both
    tables."""
    jc, tc = _cfgs(name)
    jemb, jmlp, jmeta = _jax_tables(jc, updater, seed=0)
    cat, dense, labels = jd.synthetic_ctr(jc, 4 * 64, seed=1)
    jopt = JAddOption(learning_rate=0.2, rho=0.1)
    with jax.default_matmul_precision("float32"):
        jstep = jax.jit(jd.make_train_step(jc, jemb, jmlp, jmeta,
                                           emb_opt=jopt, mlp_opt=jopt))
        es, ms = jemb.state, jmlp.state
        jl = []
        for i in range(0, 256, 64):
            es, ms, loss = jstep(es, ms, jnp.asarray(cat[i:i + 64]),
                                 jnp.asarray(dense[i:i + 64]),
                                 jnp.asarray(labels[i:i + 64]))
            jl.append(float(loss))
    jemb_data = np.asarray(es["data"])[: jd.total_rows(jc)]
    jmlp_data = np.asarray(ms["data"])[: jmlp.size]
    temb, tmlp, tmeta = _port_tables(tc, updater, jemb.get(), seed=0)
    # the JAX table's seeded init is carried across as the port's start
    topt = AddOption(learning_rate=0.2, rho=0.1)
    tstep = td.make_train_step(tc, temb, tmlp, tmeta, emb_opt=topt,
                               mlp_opt=topt)
    es, ms = temb.state, tmlp.state
    tl = []
    for i in range(0, 256, 64):
        es, ms, loss = tstep(es, ms, cat[i:i + 64], dense[i:i + 64],
                             labels[i:i + 64])
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    _close(temb.get(), jemb_data)
    _close(tmlp.get(), jmlp_data)


def test_duplicate_ids_accumulate():
    """Every sample hits row 5 of field 0: with the plain adder the table
    moves by exactly the sum of the per-sample row gradients."""
    tmv.init(device="cpu")
    tc = td.DLRMConfig(**CONFIGS["one_layer"])
    emb = tmv.MatrixTable(td.total_rows(tc), tc.embed_dim,
                          updater="default", seed=3, init_scale=0.05,
                          name="dlrm_emb_dup")
    flat, meta = td.flatten_mlp(td.init_mlp_params(tc, 3))
    mlp = tmv.ArrayTable(flat.size, updater="default", init=flat,
                         name="dlrm_mlp_dup")
    cat = np.asarray([[5, 1], [5, 2], [5, 3], [5, 4]], np.int32)
    dense = np.ones((4, 2), np.float32)
    labels = np.asarray([1, 0, 1, 0], np.float32)
    ids = (cat + td.field_offsets(tc)[None, :]).reshape(-1)
    before = emb.get()
    params = td.unflatten_mlp(torch.from_numpy(flat), meta)
    _, _, g_rows = td.loss_and_grads(
        params, torch.from_numpy(before[ids].reshape(4, 2, 4)),
        torch.from_numpy(dense), torch.from_numpy(labels), tc)
    expect = before.copy()
    np.add.at(expect, ids, g_rows.reshape(8, 4).numpy())
    step = td.make_train_step(tc, emb, mlp, meta)
    step(emb.state, mlp.state, cat, dense, labels)
    np.testing.assert_allclose(emb.get(), expect, rtol=1e-5, atol=1e-6)


def test_learns_planted_structure():
    tmv.init(device="cpu")
    tc = td.DLRMConfig(**CONFIGS["small"])
    emb = tmv.MatrixTable(td.total_rows(tc), tc.embed_dim,
                          updater="adagrad", seed=0, init_scale=0.05,
                          name="dlrm_emb_learn")
    flat, meta = td.flatten_mlp(td.init_mlp_params(tc, 0))
    mlp = tmv.ArrayTable(flat.size, updater="adagrad", init=flat,
                         name="dlrm_mlp_learn")
    cat, dense, labels = td.synthetic_ctr(tc, 4096, seed=1)
    opt = AddOption(learning_rate=0.2, rho=0.1)
    step = td.make_train_step(tc, emb, mlp, meta, emb_opt=opt, mlp_opt=opt)
    es, ms = emb.state, mlp.state
    means = []
    for _ in range(6):
        ep = []
        for i in range(0, len(labels), 256):
            es, ms, loss = step(es, ms, cat[i:i + 256], dense[i:i + 256],
                                labels[i:i + 256])
            ep.append(loss.item())
        means.append(np.mean(ep))
    assert means[-1] < means[0] - 0.05, means


def test_config_validation():
    with pytest.raises(ValueError, match="bottom_mlp"):
        td._mlp_shapes(td.DLRMConfig(bottom_mlp=(32, 8), embed_dim=16))
    with pytest.raises(ValueError, match="top_mlp"):
        td._mlp_shapes(td.DLRMConfig(top_mlp=(32, 2)))
