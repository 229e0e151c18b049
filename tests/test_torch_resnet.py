"""Port parity, ResNet-CIFAR: ``models/resnet.py`` and
``apps/resnet_cifar.py`` of multiverso_tpu_torch against multiverso_tpu's
(tests/test_resnet.py) from one ``init_resnet`` tree, carried over with
``resnet_from_jax``, on ``synthetic_cifar`` images (depth 8, 16x16).

Tolerances, each stated at its assertion: the flat parameter vector and
the data bit for bit; a SAME convolution within 1e-5 of
``lax.conv_general_dilated``; the forward logits and the new BatchNorm
stats within 1e-4; one step's flat gradient within 1e-4 of max |g| of each
leaf; after 3 trainer steps the losses within 1e-4 relative and the
table within ``2 * lr * steps`` absolute, with at least 99.9% of its
elements within 1e-6. Adam moves nearly every weight by about ``lr`` on
its first steps whatever the gradient's size, so a near-zero gradient
whose sign the two packages' f32 sums disagree on moves that weight by up
to ``2 * lr`` a step: that is the bound, and the 99.9% share is what
shows the two updates are the same. The JAX side runs under f32 matmul
precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.apps import resnet_cifar as japp
from multiverso_tpu.models import resnet as jres
from multiverso_tpu_torch.apps import resnet_cifar as tapp
from multiverso_tpu_torch.models import resnet as tres
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.zoo import Zoo as TZoo

CONV_ATOL = 1e-5
FWD_ATOL = 1e-4
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-4
CLOSE_ATOL, CLOSE_SHARE = 1e-6, 0.999


@pytest.fixture(autouse=True)
def _runtimes():
    yield
    if jmv.Zoo.get().started:
        jmv.shutdown()
    if TZoo.get().started:
        TZoo.get().stop()
    tconfig.reset_flags()


# every tree below has the trainer's shapes (depth 8, width 16, 4
# classes), so the JAX package's eager init compiles its draws once
SHAPES = dict(depth=8, num_classes=4)


def _jax_tree(seed=0):
    params, bn = jres.init_resnet(jax.random.key(seed), **SHAPES)
    return params, bn, jax.tree.map(np.asarray, params), \
        jax.tree.map(np.asarray, bn)


@pytest.mark.parametrize("seed", [0, 1])
def test_flat_vector_and_meta_equal_jax(seed):
    jp, _, npp, _ = _jax_tree(seed)
    want, jmeta = jres.flatten_params(jp)
    got, meta = tres.flatten_params(npp)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert [s for _, s in meta] == [tuple(s) for s in jmeta[1]]
    # the views unflatten to the same leaves
    back = tres.unflatten_params(torch.from_numpy(got), meta)
    for (pa, a), (pb, b) in zip(tres._leaves(npp), tres._leaves(back)):
        assert pa == pb
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("depth,width", [(8, 16), (20, 8)])
def test_port_init_has_the_jax_shapes_and_scales(depth, width):
    jp, jbn = jax.eval_shape(
        lambda k: jres.init_resnet(k, depth=depth, num_classes=4,
                                   width=width), jax.random.key(0))
    params, bn = tres.init_resnet(0, depth=depth, num_classes=4,
                                  width=width)
    jleaves = list(tres._leaves(jp))
    leaves = list(tres._leaves(params))
    assert [(p, a.shape) for p, a in jleaves] == \
        [(p, tuple(t.shape)) for p, t in leaves]
    for path, t in leaves:
        if path[-1] == "head_b":
            assert not t.any()
            continue
        fan_in = int(np.prod(t.shape[:-1]))
        scale = np.sqrt((1.0 if path[-1] == "head_w" else 2.0) / fan_in)
        # the He fan-in scaling, within 25% on these draws
        assert abs(float(t.std()) / scale - 1) < 0.25, path
    assert [p for p, _ in tres._leaves(bn)] == \
        [p for p, _ in tres._leaves(jbn)]
    with pytest.raises(ValueError, match="6n\\+2"):
        tres.init_resnet(0, depth=9)


@pytest.mark.parametrize("size,k,stride", [
    (16, 3, 2), (16, 1, 2), (15, 3, 2), (16, 3, 1), (8, 1, 1), (7, 3, 2)])
def test_same_conv_matches_lax(size, k, stride):
    rng = np.random.default_rng(size * 10 + k)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 5)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jres._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tres._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w), stride).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CONV_ATOL)


def _images(n=4, seed=0):
    x, y = jres.synthetic_cifar(n, size=16, classes=4, seed=seed)
    tx, ty = tres.synthetic_cifar(n, size=16, classes=4, seed=seed)
    np.testing.assert_array_equal(tx, x)
    np.testing.assert_array_equal(ty, y)
    return x, y


@pytest.mark.parametrize("train", [True, False])
def test_forward_logits_and_bn_stats_match_jax(train):
    jp, jbn, npp, nbn = _jax_tree(0)
    x, _ = _images()
    with jax.default_matmul_precision("float32"):
        want, wbn = jax.jit(jres.apply_resnet, static_argnums=3)(
            jp, jbn, jnp.asarray(x), train)
    flat, meta = tres.flatten_params(npp)
    with torch.no_grad():
        got, gbn = tres.apply_resnet(
            tres.unflatten_params(torch.from_numpy(flat), meta),
            tres.bn_to_device(nbn, "cpu"), torch.from_numpy(x), train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)
    wl = list(tres._leaves(jax.tree.map(np.asarray, wbn)))
    gl = list(tres._leaves(gbn))
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, a), (_, b) in zip(wl, gl):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=FWD_ATOL,
                                   err_msg=str(path))
    if train:   # the running stats moved
        assert not np.allclose(gbn["stem"]["mean"].numpy(), 0.0)


def test_one_step_flat_gradient_matches_jax():
    jp, jbn, npp, nbn = _jax_tree(0)
    x, y = _images(8, seed=1)
    with jax.default_matmul_precision("float32"):
        (wloss, _), grads = jax.jit(jax.value_and_grad(
            jres.loss_fn, has_aux=True))(jp, jbn, jnp.asarray(x),
                                         jnp.asarray(y))
    want, _ = jres.flatten_params(grads)
    flat, meta = tres.flatten_params(npp)
    f = torch.from_numpy(flat).requires_grad_()
    loss, _ = tres.loss_fn(tres.unflatten_params(f, meta),
                           tres.bn_to_device(nbn, "cpu"),
                           torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(wloss), rtol=LOSS_RTOL)
    got = f.grad.numpy()
    off = 0
    for path, shape in meta:
        n = int(np.prod(shape))
        a, b = want[off:off + n], got[off:off + n]
        off += n
        assert np.abs(a - b).max() <= GRAD_RTOL * np.abs(a).max(), path


def test_trainer_three_steps_match_jax():
    jmv.init()
    tmv.init(device="cpu")
    lr, steps = 3e-3, 3
    kw = dict(depth=8, num_classes=4, image_size=16, batch_size=16,
              learning_rate=lr)
    x, y = _images(16 * steps, seed=1)
    jt = japp.ResNetTrainer(seed=0, **kw)
    with jax.default_matmul_precision("float32"):
        want = jt.train(x, y, epochs=1)
    _, _, params, bn = _jax_tree(0)
    init = tres.resnet_from_jax(params, bn)
    tt = tapp.ResNetTrainer(init=init, **kw)
    got = tt.train(x, y, epochs=1)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    a = np.asarray(jt.table.get())[: jt.n_params]
    b = tt.table.get()[: tt.n_params]
    err = np.abs(a - b)
    assert err.max() <= 2 * lr * steps, err.max()
    assert (err <= CLOSE_ATOL).mean() >= CLOSE_SHARE, (err > CLOSE_ATOL).mean()
    # the BN running stats the trainers carry
    for (p, s), (_, t) in zip(tres._leaves(jax.tree.map(np.asarray, jt.bn)),
                              tres._leaves(tt.bn)):
        np.testing.assert_allclose(t.numpy(), s, rtol=0, atol=FWD_ATOL,
                                   err_msg=str(p))


def test_trainer_learns_and_evaluates():
    tmv.init(device="cpu")
    trainer = tapp.ResNetTrainer(depth=8, num_classes=4, batch_size=16,
                                 learning_rate=3e-3)
    x, y = tres.synthetic_cifar(128, size=16, classes=4, seed=1)
    xd, yd = torch.from_numpy(x), torch.from_numpy(y)
    first = trainer.train(xd, yd, epochs=1)
    later = trainer.train(xd, yd, epochs=3)
    assert later["loss"] < first["loss"]
    acc = trainer.evaluate(*tres.synthetic_cifar(64, size=16, classes=4,
                                                 seed=2))
    assert acc > 0.4   # 4 classes: chance is 0.25
    # the remainder of 100 % 16 is dropped, as the JAX trainer drops it
    xb, yb = trainer._batches(x[:100], y[:100])
    assert tuple(xb.shape) == (6, 16, 16, 16, 3) and tuple(yb.shape) == (6, 16)
    with pytest.raises(ValueError, match="does not fit"):
        tapp.ResNetTrainer(depth=8, num_classes=4,
                           init=(np.zeros(10, np.float32), {}))


def test_main_runs_on_the_cpu_flag():
    assert tapp.main(["-depth", "8", "-num_samples", "64", "-batch_size",
                      "32", "-device=cpu"]) == 0
    assert not TZoo.get().started
