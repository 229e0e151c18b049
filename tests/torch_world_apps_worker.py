"""The apps' whole-state paths of ``multiverso_tpu_torch`` on tables
sharded over a world's ranks, and the same calls in one process: the
functions here run either way, so the world's result and the one-process
result come from one code (``tests/test_torch_world_apps.py`` on the CPU,
``chip_smoke.py``'s world part (e) on the card). Imports no jax.

One rank of a world of the CPU test, started as a launcher starts it
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; see
``tests/torch_world_worker.py``):

    python tests/torch_world_apps_worker.py OUT_DIR

It joins by ``net_init(device="cpu")``, trains every path below at the
test's small widths, writes its results to ``OUT_DIR/rank<r>.npz`` and
prints one ``RESULT <json>`` line. ``OUT_DIR/res_init.npz`` holds the
ResNet's start (the JAX package's tree, flattened by the test).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

# the CPU test's widths: tests/test_torch_word_embedding.py's ARGV and
# corpus, tests/test_torch_ps_blocks.py's SMALL on two blocks,
# tests/test_torch_logreg.py's blobs, tests/test_torch_resnet.py's trainer
WE_ARGV = ["-size", "16", "-batch_size", "256", "-shared_negatives", "32",
           "-negative", "5", "-window", "3", "-min_count", "3",
           "-sample", "1e-3", "-seed", "4"]
WE_BRANCHES = {"sg_shared": [], "sg": ["-shared_negatives", "0"],
               "hs": ["-hs", "1"], "cbow": ["-cbow", "1"],
               "cbow_hs": ["-cbow", "1", "-hs", "1"]}
PS_SMALL = dict(size=16, min_count=5, batch_size=128, negative=3,
                data_block_size=4000, seed=9, ps_device_plane="1")
PS_VARIANTS = {"sg": {}, "cbow_hs": {"cbow": 1, "hs": 1}}
PS_BLOCKS = 2
LR_PAIRS = dict(input_size="784", output_size="10",
                objective_type="softmax", updater_type="sgd",
                minibatch_size="64", learning_rate="0.05", train_epoch="1",
                sync_frequency="1")
RES_KW = dict(depth=8, num_classes=4, image_size=16, batch_size=16,
              learning_rate=3e-3)
RES_STEPS = 3
# the DLRM step: tests/test_torch_dlrm.py's "serving" config (the serving
# bench's widths), whose table outgrows a batch's rows, so a gather of it
# would show in the payloads; 4 steps of a 64-sample global batch, each
# rank its shard of it where the step has a data axis
DLRM_CFG = dict(vocab_sizes=(4096, 1024, 256, 64), embed_dim=16,
                dense_dim=8, bottom_mlp=(32, 16), top_mlp=(16, 1))
DLRM_UPDATERS = ("adagrad", "default", "momentum_sgd")
DLRM_OPT = dict(learning_rate=0.2, rho=0.1, momentum=0.5)
DLRM_STEPS, DLRM_BATCH = 4, 64
# the world of 4 (tests/test_torch_world_apps.py through mesh.spawn):
# mesh, data axis; the table axis is the mesh's last
DLRM_WORLD4 = {"by_owner": ({"mv": 4}, "mv"),
               "block_reduce": ({"dp": 2, "mv": 2}, "dp"),
               "by_owner_and_reduce": ({"dp": 2, "mv": 2}, ("dp", "mv"))}
# train_fused by owner, watched: a vocabulary (2,636 rows) 9.7-66x the
# rows a step reads (40 with the shared pool, 272 with CBOW HS), so a
# gather of a table would show beside a step's reads
WE_OWNER_ARGV = ["-size", "16", "-batch_size", "16", "-shared_negatives",
                 "8", "-negative", "5", "-window", "2", "-min_count", "1",
                 "-sample", "1e-3", "-seed", "4"]
# the branches a world of 4 trains (at WE_ARGV, on we_tokens)
WE_WORLD4 = ("sg_shared", "cbow_hs")


def we_tokens():
    from multiverso_tpu_torch.apps import word_embedding as we
    return we.synthetic_corpus(12_000, vocab=300, seed=3)


def we_owner_tokens():
    from multiverso_tpu_torch.apps import word_embedding as we
    return we.synthetic_corpus(8_000, vocab=4_000, seed=11)


def ps_tokens():
    from multiverso_tpu_torch.apps import word_embedding as we
    return we.synthetic_corpus(50_000, vocab=300, seed=5)


def lr_data():
    from multiverso_tpu_torch.models import logreg
    return logreg.synthetic_dataset(1024, 784, 10, seed=0)


def res_data():
    """(train x, y), (eval x, y): tests/test_torch_resnet.py's images."""
    from multiverso_tpu_torch.models import resnet
    return (resnet.synthetic_cifar(RES_KW["batch_size"] * RES_STEPS,
                                   size=16, classes=4, seed=1),
            resnet.synthetic_cifar(64, size=16, classes=4, seed=2))


def we_prefix(app, ids: np.ndarray, batches: int) -> np.ndarray:
    """The shortest prefix of ``ids`` from which ``app``'s fused epoch
    makes ``batches`` batches: CBOW's targets are the ids themselves;
    skip-gram's pairs grow with the prefix (a position adds at most
    2 * window pairs), so the shortest prefix with enough pairs makes
    exactly that many batches."""
    from multiverso_tpu_torch.apps import word_embedding as we
    cfg = app.cfg
    if cfg.cbow:
        return ids[: batches * cfg.batch_size]

    def enough(m: int) -> bool:
        pairs = we._gen_pairs(ids[:m], cfg.window, cfg.seed)[0].size
        return pairs // cfg.batch_size >= batches

    lo, hi = 1, ids.size
    if not enough(hi):
        raise ValueError(f"the ids make fewer than {batches} batches")
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if enough(mid) else (mid + 1, hi)
    return ids[:lo]


def we_step_reads(app) -> list:
    """The rows each step of ``app``'s fused epoch reads, table read by
    table read, in the step's order (``models/word2vec.py``): by owner,
    each is one all-reduce of that many rows of ``size`` values."""
    cfg = app.cfg
    b = cfg.batch_size
    first = b * 2 * cfg.window if cfg.cbow else b
    if cfg.hs:
        return [first, b * app._hs[0].shape[1]]
    if not cfg.cbow and cfg.shared_negatives > 0:
        return [b, b, cfg.shared_negatives]
    return [first, b * (cfg.negative + 1)]


class WEWatch:
    """What one ``train_fused`` call of ``app`` asks of the world:
    entries to any table's ``unshard``/``whole_state``, the collectives
    before its first step (``pre``) and of each step (``StepWatch``'s
    payloads, split where ``models/word2vec._scan`` starts a step), each
    step's ms on the host clock (a step's first read waits for the
    step before it), with ``tensors`` the largest tensor of the tables'
    dtype made (the negatives' 2^20-slot table and the batches are
    int64), each table's whole padded elements and this rank's block of
    them, and on the card the rise of ``max_memory_allocated`` over the
    call."""

    def __init__(self, app, tensors: bool = True):
        self.app, self.tensors = app, tensors

    def __enter__(self):
        import torch
        from multiverso_tpu_torch.models import word2vec as w2v
        from multiverso_tpu_torch.table import Table
        self.entries, self.marks = [], []
        self._saved = (Table.unshard, Table.whole_state, w2v._scan)
        unshard, whole_state, scan = self._saved
        watch = self

        def count(fn, name):
            def entered(*a, **k):
                watch.entries.append(name)
                return fn(*a, **k)
            return entered

        def marked_scan(step, win, wout, *xs):
            def marked(*a):
                watch.marks.append((len(watch.steps.payloads),
                                    time.perf_counter()))
                return step(*a)
            return scan(marked, win, wout, *xs)

        Table.unshard = count(unshard, "unshard")
        Table.whole_state = count(whole_state, "whole_state")
        w2v._scan = marked_scan
        self.cuda = self.app.table_in.device.type == "cuda"
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self._mem0 = torch.cuda.memory_allocated()
        self.steps = StepWatch(self.tensors,
                               self.app.table_in.dtype).__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        from multiverso_tpu_torch.models import word2vec as w2v
        from multiverso_tpu_torch.table import Table
        self.end = time.perf_counter()
        self.steps.__exit__(*exc)
        if self.cuda:
            self.mem_rise = torch.cuda.max_memory_allocated() - self._mem0
        Table.unshard, Table.whole_state, w2v._scan = self._saved
        return False

    def result(self) -> Dict:
        pays = self.steps.payloads
        cuts = [i for i, _ in self.marks] + [len(pays)]
        steps = [pays[a:b] for a, b in zip(cuts, cuts[1:])]
        k = max((len(s) for s in steps), default=0)
        times = [t for _, t in self.marks] + [self.end]
        app = self.app
        sec = app.table_hs if app.cfg.hs else app.table_out
        out = {"gathers": len(self.entries),
               "pre": [list(p) for p in pays[: cuts[0]]],
               "step_ops": sorted({op for s in steps for op, _ in s}),
               "step_colls": np.array([len(s) for s in steps]),
               "step_payloads": np.array(
                   [[b for _, b in s] + [0] * (k - len(s)) for s in steps],
                   dtype=np.int64).reshape(len(steps), k),
               "step_ms": np.diff(times) * 1e3,
               "reads": we_step_reads(app)}
        for name, t in (("in", app.table_in), ("out", sec)):
            out[f"whole_numel_{name}"] = int(np.prod(t.padded_shape))
            out[f"block_numel_{name}"] = int(t.state["data"].numel())
        if self.tensors:
            out["largest"] = self.steps.largest
        if self.cuda:
            out["mem_rise"] = int(self.mem_rise)
        return out


def we_fused(cfg, tokens, neg_batches: int = 0, batches: int = 0,
             watch: bool = False,
             watch_tensors: bool = True) -> Dict[str, np.ndarray]:
    """One ``train_fused`` epoch of ``cfg``'s branch over ``tokens`` (with
    ``batches``, over the prefix of the ids that makes that many,
    :func:`we_prefix`) from the seeded tables: the gathered tables
    (``in``, ``out``: embed_out or embed_hs), the loss, the word count,
    the shared pool's LCG state and, with ``neg_batches``, the per-pair
    negative ids of the epoch's first batches (the draw the epoch makes
    from its first key). With ``watch``, a :class:`WEWatch`'s record of
    the call, its keys prefixed ``watch/``."""
    import torch
    from multiverso_tpu_torch.apps import word_embedding as we
    from multiverso_tpu_torch.models import word2vec as w2v
    from multiverso_tpu_torch.utils import threefry
    app = we.WordEmbedding(cfg, we.Dictionary.build(tokens, cfg.min_count))
    ids = app.prepare_ids(tokens)
    if batches:
        ids = we_prefix(app, ids, batches)
    t0 = time.perf_counter()
    if watch:
        with WEWatch(app, watch_tensors) as w:
            stats = app.train_fused(ids, epochs=1)
    else:
        stats = app.train_fused(ids, epochs=1)
    out = {"seconds": time.perf_counter() - t0, "loss": stats["loss"],
           "batches": stats["pairs"] // cfg.batch_size}
    if watch:
        out.update({f"watch/{k}": v for k, v in w.result().items()})
    out.update({"in": app.embeddings(),
                "out": (app.table_hs if cfg.hs else app.table_out).get(),
                "words": app.total_word_count(), "tokens": ids.size})
    if app._lcg is not None:
        out["lcg"] = app._lcg.cpu().numpy()
    if neg_batches and not cfg.hs and cfg.shared_negatives <= 0:
        *batches, _ = (app._device_cbow(ids) if cfg.cbow
                       else app._device_pairs(ids))
        key = threefry.split(threefry.key(cfg.seed))[1]
        table = torch.from_numpy(w2v.build_negative_table(
            app.unigram).astype(np.int64)).to(app.table_in.device)
        nb, b = batches[-1].shape
        out["negs"] = w2v.epoch_negatives(
            key, table, min(nb, neg_batches), b, cfg.negative).cpu().numpy()
    return out


def we_blocks(cfg, ids: np.ndarray, tokens) -> Dict[str, np.ndarray]:
    """One ``train_ps_blocks`` epoch over ``ids`` on the device plane, as
    one worker (the ``num_workers`` flag 1): the gathered tables, each
    block's loss, the run's loss and the word count."""
    from multiverso_tpu_torch.apps import word_embedding as we
    from multiverso_tpu_torch.utils import config
    before = config.get_flag("num_workers")
    config.set_flag("num_workers", 1)
    try:
        app = we.WordEmbedding(cfg, we.Dictionary.build(tokens,
                                                         cfg.min_count))
        losses, inner = [], app._train_block_device

        def record(prep):
            loss = inner(prep)
            losses.append(loss)
            return loss

        app._train_block_device = record
        t0 = time.perf_counter()
        stats = app.train_ps_blocks(ids, epochs=1)
        sec = app.table_hs if cfg.hs else app.table_out
        return {"seconds": time.perf_counter() - t0, "loss": stats["loss"],
                "block_losses": np.array([float(x) for x in losses]),
                "in": app.table_in.get(), "out": sec.get(),
                "words": app.total_word_count()}
    finally:
        config.set_flag("num_workers", before)


def lr_fused(pairs: Dict[str, str], x: np.ndarray,
             y: np.ndarray) -> Dict[str, np.ndarray]:
    """One ``LogReg.train_arrays`` epoch: the table's Get and the loss."""
    from multiverso_tpu_torch.apps import logistic_regression as lr
    app = lr.LogReg(lr.LogRegConfig(pairs))
    stats = app.train_arrays(x, y, epochs=1)
    return {"seconds": stats["seconds"], "loss": stats["loss"],
            "table": app.table.get()}


def resnet(kw: Dict, train, evaluate, init: Optional[tuple] = None,
           first_steps: int = 0) -> Dict[str, np.ndarray]:
    """``ResNetTrainer.train`` for one epoch over ``train`` (x, y), then
    ``evaluate`` on ``evaluate``: the flat table, the loss, the first
    step's flat gradient as Adam received it (gathered), the BN running
    stats (flattened in the tree's order) and the accuracy. With
    ``first_steps`` the epoch is two calls, the first over that many
    batches (its loss ``loss_first``), the second over the rest."""
    from multiverso_tpu_torch.apps import resnet_cifar
    from multiverso_tpu_torch.models import resnet as res
    trainer = resnet_cifar.ResNetTrainer(init=init, **kw)
    deltas, inner = [], trainer.table.functional_add

    def record(state, delta, opt=None):
        if not deltas:
            deltas.append(delta.clone())
        return inner(state, delta, opt)

    trainer.table.functional_add = record
    out = {}
    x, y = train
    n = first_steps * kw["batch_size"]
    if n:
        first = trainer.train(x[:n], y[:n], epochs=1)
        out.update(loss_first=first["loss"], seconds_first=first["seconds"])
    stats = trainer.train(x[n:], y[n:], epochs=1)
    grad = trainer.table.unshard(deltas[0])[: trainer.n_params]
    bn, _ = res.flatten_params(trainer.bn)
    out.update(seconds=stats["seconds"], loss=stats["loss"],
               table=trainer.table.get()[: trainer.n_params],
               grad=grad.cpu().numpy(), bn=bn,
               eval=trainer.evaluate(*evaluate))
    return out


def res_init(path: str) -> tuple:
    """The (flat vector, BN tree) a test saved with :func:`save_res_init`,
    as ``ResNetTrainer(init=...)`` takes it."""
    import torch
    from multiverso_tpu_torch.models import resnet as res
    got = np.load(path)
    _, bn = res.init_resnet(0, depth=RES_KW["depth"],
                            num_classes=RES_KW["num_classes"])
    _, meta = res.flatten_params(bn)
    return got["flat"], res.unflatten_params(
        torch.from_numpy(got["bn"].copy()), meta)


def save_res_init(path: str, flat: np.ndarray, bn_flat: np.ndarray) -> None:
    np.savez(path, flat=flat, bn=bn_flat)


def dlrm_data(cfg_kw: Dict = DLRM_CFG, steps: int = DLRM_STEPS,
              batch: int = DLRM_BATCH, seed: int = 1):
    """(cat, dense, labels) of ``steps`` global batches, the JAX
    package's draws (``synthetic_ctr``)."""
    from multiverso_tpu_torch.models import dlrm
    return dlrm.synthetic_ctr(dlrm.DLRMConfig(**cfg_kw), steps * batch,
                              seed=seed)


def dlrm_init(cfg_kw: Dict = DLRM_CFG) -> np.ndarray:
    """The embedding table's start, the same in both packages."""
    rows = int(sum(cfg_kw["vocab_sizes"]))
    return np.random.default_rng(7).uniform(
        -0.05, 0.05, (rows, cfg_kw["embed_dim"])).astype(np.float32)


class StepWatch:
    """What a block of code asks of the world: each collective's op and
    payload as ``telemetry/devstats`` records it (``payloads``), and with
    ``tensors`` the most elements of any tensor an operator made
    (``largest``, through a ``TorchDispatchMode``: its first use in a
    process costs seconds of imports, 9.7 s in a rank on the card), with
    ``dtype`` only of tensors of that dtype."""

    def __init__(self, tensors: bool = True, dtype=None):
        self.tensors, self.dtype = tensors, dtype

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        from multiverso_tpu_torch.telemetry import devstats
        import torch
        self.payloads, self.largest = [], 0
        ds, watch = devstats.DEVSTATS, self
        inner = ds.collective_span

        def span(op, nbytes, mesh=None):
            watch.payloads.append((op, int(nbytes)))
            return inner(op, nbytes, mesh=mesh)

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor) and watch.dtype in (
                            None, t.dtype):
                        watch.largest = max(watch.largest, t.numel())
                return out

        ds.collective_span = span
        self._ds, self._mode = ds, Mode() if self.tensors else None
        if self._mode is not None:
            self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self._mode is not None:
            self._mode.__exit__(*exc)
        del self._ds.collective_span
        return False


def dlrm_steps(updater: str, opt: Dict, data, steps: int, batch: int,
               cfg_kw: Dict = DLRM_CFG, axis=None, table_kw=None,
               watch=(), watch_tensors: bool = True, gather: bool = True,
               first: bool = True, dtype=np.float32) -> Dict:
    """``steps`` steps of ``models/dlrm.make_train_step`` on a fresh
    MatrixTable and ArrayTable of the Zoo in ``dtype`` (the embedding
    table from ``table_kw``, by default :func:`dlrm_init`; the MLP from
    seed 0). With
    ``axis`` the step averages over that data axis of the Zoo's mesh and
    this rank takes its shard of each global batch of ``data``; without,
    every rank takes the whole batch. Returns each step's loss and ms,
    ``Table.unshard`` calls on the embedding table, for the steps in
    ``watch`` a :class:`StepWatch`'s payloads and (``watch_tensors``)
    largest tensor, each
    step's collective bytes (``telemetry/devstats``' tally), on the card
    each step's ``max_memory_allocated`` rise, and the tables: their
    ``get()`` with ``gather``, else this rank's blocks (``emb_block``,
    its first row ``emb_lo``) and the MLP's ``get()``. ``emb_first`` is the
    embedding table after the first step (with ``gather`` and
    ``first``)."""
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models import dlrm
    from multiverso_tpu_torch.telemetry import devstats
    from multiverso_tpu_torch.updaters import AddOption
    from multiverso_tpu_torch.zoo import Zoo
    cfg = dlrm.DLRMConfig(**cfg_kw, dtype=torch.from_numpy(
        np.zeros(0, dtype)).dtype)
    mesh = Zoo.get().mesh()
    rows = dlrm.total_rows(cfg)
    emb = mv.MatrixTable(rows, cfg.embed_dim, dtype=dtype, updater=updater,
                         name=f"dlrm_emb_{updater}",
                         **(table_kw or {"init": dlrm_init(cfg_kw)}))
    flat, meta = dlrm.flatten_mlp(dlrm.init_mlp_params(cfg, 0))
    mlp = mv.ArrayTable(flat.size, dtype=dtype, updater=updater, init=flat,
                        name=f"dlrm_mlp_{updater}")
    gathers, unshard = [], emb.unshard
    emb.unshard = lambda block: (gathers.append(1), unshard(block))[1]
    o = AddOption(**opt)
    step = dlrm.make_train_step(cfg, emb, mlp, meta, o, o,
                                mesh=mesh if axis else None, axis=axis)
    part = mesh.index(axis) if axis else 0
    per = batch // (mesh.axis_size(axis) if axis else 1)
    cuda = emb.device.type == "cuda"
    cat, dense, labels = data
    dense, labels = dense.astype(dtype), labels.astype(dtype)
    es, ms = emb.state, mlp.state
    out = {"losses": [], "ms": [], "mem_rise": [], "payloads": [],
           "largest": [], "bytes": []}

    def moved() -> int:
        return sum(d["bytes"] for d in devstats.collectives().values())

    for i in range(steps):
        sl = slice(i * batch + part * per, i * batch + (part + 1) * per)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        b0, t0 = moved(), time.perf_counter()
        if i in watch:
            with StepWatch(watch_tensors) as w:
                es, ms, loss = step(es, ms, cat[sl], dense[sl], labels[sl])
            out["payloads"].append(w.payloads)
            out["largest"].append(w.largest)
        else:
            es, ms, loss = step(es, ms, cat[sl], dense[sl], labels[sl])
        out["losses"].append(loss.item())
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["bytes"].append(moved() - b0)
        if cuda:
            out["mem_rise"].append(torch.cuda.max_memory_allocated()
                                   - before)
        if i == 0 and gather and first:
            out["emb_first"] = emb.get()
    out["losses"] = np.array(out["losses"])
    out["unshard_calls"] = len(gathers)
    out["whole_numel"] = int(np.prod(emb.padded_shape))
    out["mlp_padded"] = int(mlp.padded_shape[0])
    if gather:
        out["emb"] = emb.get()
    else:
        out["emb_block"] = es["data"].cpu().numpy()
        out["emb_lo"] = emb.sharding.rows[0]
    out["mlp"] = mlp.get()
    return out


def world4(rank: int, world: int, device) -> Dict:
    """A rank of the world of 4 (``mesh.spawn``): the DLRM step with
    AdaGrad in float64 on each layout of ``DLRM_WORLD4``, each in a fresh
    Zoo over its mesh, the tables gathered, every step watched; then
    ``train_fused`` of each branch of ``WE_WORLD4`` in f32 on a table axis
    of 4, watched."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps import word_embedding as we
    from multiverso_tpu_torch.parallel.mesh import Mesh
    out = {}
    mv.init(device=device, mesh=Mesh({"mv": world}, device=device))
    try:
        tokens = we_tokens()
        for name in WE_WORLD4:
            out[f"we_{name}"] = we_fused(we.WEConfig.from_argv(
                WE_ARGV + WE_BRANCHES[name]), tokens, watch=True)
    finally:
        mv.shutdown()
    for name, (shape, axis) in DLRM_WORLD4.items():
        mv.init(device=device, mesh=Mesh(shape, device=device))
        try:
            out[name] = dlrm_steps("adagrad", DLRM_OPT, dlrm_data(),
                                   DLRM_STEPS, DLRM_BATCH, axis=axis,
                                   watch=range(DLRM_STEPS),
                                   dtype=np.float64)
        finally:
            mv.shutdown()
    return out


def mismatches(rank: int) -> Dict[str, bool]:
    """Each path given other inputs on rank 1 than on rank 0: whether it
    raised ``ValueError`` on this rank (every rank must)."""
    from multiverso_tpu_torch.apps import logistic_regression as lr
    from multiverso_tpu_torch.apps import resnet_cifar
    from multiverso_tpu_torch.apps import word_embedding as we
    tokens = we_tokens()
    cfg = we.WEConfig.from_argv(WE_ARGV)
    app = we.WordEmbedding(cfg, we.Dictionary.build(tokens, cfg.min_count))
    ids = app.prepare_ids(tokens)
    x, y = lr_data()
    (rx, ry), _ = res_data()
    trainer = resnet_cifar.ResNetTrainer(**RES_KW)
    cases = {
        "we_fused": lambda: app.train_fused(ids[: ids.size - rank],
                                            epochs=1),
        "we_blocks": lambda: we_blocks(
            we.WEConfig(**PS_SMALL), ids[rank:], tokens),
        "lr": lambda: lr.LogReg(lr.LogRegConfig(LR_PAIRS)).train_arrays(
            x + np.float32(rank), y, epochs=1),
        "resnet": lambda: trainer.train(rx, (ry + rank) % 4, epochs=1),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = False
        except ValueError:
            out[name] = True
    return out


def run_world(out_dir: str) -> Dict:
    """Every path on this rank at the CPU test's widths; the arrays go to
    ``out_dir/rank<r>.npz``, the scalars into the returned dict."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.apps import word_embedding as we
    rank = mv.rank()
    arrays, scalars = {}, {"rank": rank, "size": mv.size()}

    def keep(prefix, got):
        for k, v in got.items():
            if isinstance(v, np.ndarray):
                arrays[f"{prefix}/{k}"] = v
            else:
                scalars[f"{prefix}/{k}"] = v

    tokens, owner_tokens = we_tokens(), we_owner_tokens()
    for name, extra in WE_BRANCHES.items():
        keep(f"we_{name}", we_fused(we.WEConfig.from_argv(WE_ARGV + extra),
                                    tokens))
        keep(f"we_owner_{name}", we_fused(
            we.WEConfig.from_argv(WE_OWNER_ARGV + extra), owner_tokens,
            watch=True))
    ptoks = ps_tokens()
    for name, extra in PS_VARIANTS.items():
        cfg = we.WEConfig(**PS_SMALL, **extra)
        ids = we.WordEmbedding(cfg, we.Dictionary.build(
            ptoks, cfg.min_count)).prepare_ids(ptoks)
        keep(f"ps_{name}", we_blocks(cfg, ids[: PS_BLOCKS
                                              * cfg.data_block_size], ptoks))
    keep("lr", lr_fused(LR_PAIRS, *lr_data()))
    train, evaluate = res_data()
    keep("res", resnet(RES_KW, train, evaluate,
                       res_init(os.path.join(out_dir, "res_init.npz"))))
    data, axis = dlrm_data(), mv.Zoo.get().shard_axis()
    for u in DLRM_UPDATERS:
        keep(f"dlrm_{u}", dlrm_steps(u, DLRM_OPT, data, DLRM_STEPS,
                                     DLRM_BATCH, axis=axis,
                                     watch=range(DLRM_STEPS)))
    keep("dlrm_global", dlrm_steps("adagrad", DLRM_OPT, data, DLRM_STEPS,
                                   DLRM_BATCH, watch=range(DLRM_STEPS)))
    scalars["mismatch"] = mismatches(rank)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    return scalars


def main() -> None:
    out_dir = sys.argv[1]
    import torch
    torch.set_num_threads(1)
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.parallel.mesh import leave_world
    from multiverso_tpu_torch.utils import config
    config.set_flag("net_timeout_s", 90.0)
    if mv.net_init(device="cpu") != 0:
        sys.exit(f"rank {os.environ.get('RANK')}: net_init failed")
    try:
        mv.init(device="cpu")
        out = run_world(out_dir)
        mv.shutdown()
    finally:
        leave_world()
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
