"""Rank bodies for the port's mesh tests (``tests/test_torch_*.py`` of the
parallel layers): a :class:`World` spawns N CPU ranks over gloo once, and
each test sends a named case with numpy inputs to every rank and gets
every rank's numpy result back. A spawned rank imports this module, the
port and torch, never jax.
"""

from __future__ import annotations

import os
import queue
import sys
import tempfile
import traceback
from typing import Any, Dict, List

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CASES: Dict[str, Any] = {}
_MESHES: Dict[Any, Any] = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def mesh(shape) -> Any:
    """The rank's mesh of ``shape`` (a list of (axis, size)), built once
    per world: its process groups are made collectively."""
    from multiverso_tpu_torch.parallel.mesh import Mesh
    key = tuple(tuple(s) for s in shape)
    if key not in _MESHES:
        _MESHES[key] = Mesh(list(key), device="cpu")
    return _MESHES[key]


def serve(rank: int, world: int, store: str, inq, outq) -> None:
    import torch
    torch.set_num_threads(1)
    from multiverso_tpu_torch.parallel.mesh import init_world, leave_world
    init_world(rank, world, store, "cpu")
    try:
        while True:
            msg = inq.get()
            if msg is None:
                break
            name, kwargs = msg
            try:
                out = CASES[name](rank=rank, world=world, **kwargs)
                outq.put((rank, "ok", out))
            except Exception as e:   # noqa: BLE001 — reported to the test
                outq.put((rank, "error", f"{type(e).__name__}: {e}\n"
                          + traceback.format_exc()))
    finally:
        leave_world()


class World:
    """N spawned CPU ranks over gloo serving cases until closed."""

    def __init__(self, n: int, timeout: float = 120.0):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.n = n
        self.timeout = timeout
        self._tmp = tempfile.TemporaryDirectory(prefix="mv_mesh_test_")
        store = os.path.join(self._tmp.name, "store")
        self._in = [ctx.Queue() for _ in range(n)]
        self._out = ctx.Queue()
        self._procs = [ctx.Process(target=serve,
                                   args=(r, n, store, self._in[r],
                                         self._out), daemon=True)
                       for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, name: str, **kwargs) -> List[Any]:
        """Run case ``name`` on every rank; their results in rank order."""
        self.submit(name, **kwargs)
        return self.collect()

    def submit(self, name: str, **kwargs) -> None:
        """Start case ``name`` on every rank (the test process is free to
        compute its JAX side meanwhile); :meth:`collect` its results."""
        self._pending = name
        for q in self._in:
            q.put((name, kwargs))

    def collect(self) -> List[Any]:
        name = self._pending
        got: Dict[int, Any] = {}
        while len(got) < self.n:
            try:
                rank, status, val = self._out.get(timeout=self.timeout)
            except queue.Empty:
                raise TimeoutError(f"case {name}: ranks "
                                   f"{sorted(set(range(self.n)) - set(got))}"
                                   f" gave no result") from None
            if status != "ok":
                self.close(kill=True)
                raise RuntimeError(f"case {name}, rank {rank}:\n{val}")
            got[rank] = val
        return [got[r] for r in range(self.n)]

    def close(self, kill: bool = False) -> None:
        if not kill:
            for q in self._in:
                q.put(None)
        for p in self._procs:
            p.join(timeout=0 if kill else 30)
            if p.is_alive():
                p.kill()
                p.join()
        self._tmp.cleanup()


# ---------------------------------------------------------------------- #
# helpers for the cases
# ---------------------------------------------------------------------- #
def block(arr: np.ndarray, spec, m):
    """This rank's block of a global array under ``spec``, and the block's
    (start, stop) per dim so the test can put it back."""
    from multiverso_tpu_torch.parallel.tp import local_slices
    sl = local_slices(arr.shape, spec, m)
    bounds = [s.indices(n)[:2] for s, n in zip(sl, arr.shape)]
    return np.ascontiguousarray(arr[sl]), bounds


def assemble(parts, shape, sum_copies: bool = False) -> np.ndarray:
    """The global array from the ranks' (block, bounds) pairs. A block
    that several ranks hold must be the same on each, or with
    ``sum_copies`` is their sum (a gradient of a weight replicated over a
    data axis: each rank holds its batch shard's part)."""
    out = np.full(shape, np.nan, np.float64)
    for arr, bounds in parts:
        idx = tuple(slice(a, b) for a, b in bounds)
        prev = out[idx]
        seen = ~np.isnan(prev)
        arr = np.asarray(arr, np.float64)
        if seen.any():
            if sum_copies:
                arr = np.where(seen, prev + arr, arr)
            else:
                np.testing.assert_array_equal(prev[seen], arr[seen])
        out[idx] = arr
    return out


def t(x, grad: bool = False):
    import torch
    out = torch.as_tensor(np.asarray(x))
    return out.requires_grad_() if grad else out


def np_(x) -> np.ndarray:
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------- #
# collectives
# ---------------------------------------------------------------------- #
@case
def coll_public(rank, world, shape, axis, x):
    """The host-plane collectives on this rank's chunk of ``x``, and what
    devstats and the flight recorder saw of them."""
    from multiverso_tpu_torch import parallel
    from multiverso_tpu_torch.parallel import collectives as coll
    from multiverso_tpu_torch.telemetry import devstats, flightrec
    devstats.reset()
    flightrec.reset()
    coll.reset_staged_counts()
    m = mesh(shape)
    n, i = m.axis_size(axis), m.index(axis)
    c = x.shape[0] // n
    chunk = t(x[i * c:(i + 1) * c])
    out = {
        "all_reduce": np_(parallel.all_reduce(chunk, axis, m)),
        "all_gather": np_(parallel.all_gather(chunk, axis, m)),
        # rank i contributes (i + 1) * x: the ranks' sum is x * n(n+1)/2
        "reduce_scatter": np_(parallel.reduce_scatter(t(x * (i + 1)), axis,
                                                      m)),
        "broadcast": np_(parallel.broadcast(chunk, 1, axis, m)),
        "process_sum": coll.process_sum(np.full(3, rank, np.float64)),
        "index": i,
        "collectives": devstats.collectives(),
        "snapshot": devstats.stats_snapshot(),
        "staged": coll.staged_counts(),
        "events": [e[2] for e in flightrec.RECORDER.snapshot()],
    }
    return out


_GRAD_OPS = ("all_gather_grad", "reduce_scatter_grad", "all_to_all",
             "ppermute", "copy_to", "reduce_from", "gather_from",
             "scatter_to")


@case
def coll_grads(rank, world, shape, axis, xs, rs):
    """Each differentiable collective on this rank's x (``xs[rank]``),
    the objective sum(f(x) * r) with this rank's r; returns f(x) and
    dx per op."""
    from multiverso_tpu_torch.parallel import collectives as coll
    m = mesh(shape)
    out = {}
    for op in _GRAD_OPS:
        x = t(xs[rank], grad=True)
        if op in ("all_gather_grad", "reduce_scatter_grad"):
            y = getattr(coll, op)(x, m, axis, 0)
        elif op == "all_to_all":
            y = coll.all_to_all(x, m, axis, split_dim=0, concat_dim=1)
        elif op == "ppermute":
            y = coll.ppermute(x, m, axis, coll.ring_perm(m.axis_size(axis)))
        elif op in ("gather_from", "scatter_to"):
            y = getattr(coll, op)(x, m, axis, 0)
        else:
            y = getattr(coll, op)(x, m, axis)
        r = t(rs[rank][tuple(slice(0, s) for s in y.shape)])
        (y * r).sum().backward()
        out[op] = (np_(y), np_(x.grad))
    return out


# ---------------------------------------------------------------------- #
# sequence parallelism
# ---------------------------------------------------------------------- #
@case
def ring_attn(rank, world, shape, kind, q, k, v, r, causal=True,
              seq_axis="sp", batch_axis=None, head_axis=None):
    """ring / zigzag / ulysses on this rank's block of global q, k, v (the
    zigzag inputs already in zigzag order); the objective sum(o * r).
    Returns (block, bounds) of o, dq, dk, dv."""
    from multiverso_tpu_torch.parallel import ring
    from multiverso_tpu_torch.parallel.mesh import P
    m = mesh(shape)
    spec = P(batch_axis, head_axis, seq_axis, None)
    (ql, bounds), (kl, _), (vl, _), (rl, _) = (block(a, spec, m)
                                                for a in (q, k, v, r))
    tq, tk, tv = t(ql, True), t(kl, True), t(vl, True)
    if kind == "ring":
        o = ring.ring_attention(tq, tk, tv, seq_axis, m, causal=causal,
                                batch_axis=batch_axis, head_axis=head_axis)
    elif kind == "zigzag":
        o = ring.zigzag_ring_attention(tq, tk, tv, seq_axis, m,
                                       batch_axis=batch_axis,
                                       head_axis=head_axis)
    else:
        o = ring.ulysses_attention(tq, tk, tv, seq_axis, m, causal=causal,
                                   batch_axis=batch_axis)
    (o * t(rl)).sum().backward()
    return [(np_(a), bounds) for a in (o, tq.grad, tk.grad, tv.grad)]


@case
def seq_shard(rank, world, shape, x, axis):
    from multiverso_tpu_torch.parallel import ring
    return np_(ring.sequence_shard(x, axis, mesh=mesh(shape)))


# ---------------------------------------------------------------------- #
# tensor parallelism
# ---------------------------------------------------------------------- #
@case
def tp_mlp(rank, world, shape, x, w1, w2, r, x_axis=None):
    """column_parallel -> gelu -> row_parallel (mlp_block) on this rank's
    blocks; returns (block, bounds) of y and of the gradients of
    sum(y * r) for x, w1, w2."""
    import torch
    from multiverso_tpu_torch.parallel import tp
    from multiverso_tpu_torch.parallel.mesh import P
    m = mesh(shape)
    xs = P(x_axis, None)
    (xl, xb), (w1l, w1b), (w2l, w2b), (rl, _) = (
        block(x, xs, m), block(w1, P(None, "tp"), m),
        block(w2, P("tp", None), m), block(r, xs, m))
    tx, t1, t2 = t(xl, True), t(w1l, True), t(w2l, True)
    y = tp.mlp_block(tx, t1, t2, "tp", m,
                     x_spec=P(x_axis) if x_axis else None)
    (y * t(rl)).sum().backward()
    # the column block alone too: its output stays sharded on the last dim
    with torch.no_grad():
        col = tp.column_parallel(tx, t1, "tp", m)
    colb = [b for b in xb[:1]] + [w1b[1]]
    return [(np_(y), xb), (np_(tx.grad), xb), (np_(t1.grad), w1b),
            (np_(t2.grad), w2b), (np_(col), colb)]


@case
def tp_shard_roundtrip(rank, world, shape, tree, rules_kind):
    """shard_params then gather_params of a numpy tree under the TP or
    FSDP rules; returns this rank's shard shapes and the gathered tree."""
    from multiverso_tpu_torch.parallel import tp
    m = mesh(shape)
    rules = (tp.transformer_tp_rules("tp") if rules_kind == "tp"
             else tp.transformer_fsdp_rules("dp"))
    shards = tp.shard_params(tree, rules, m)
    shapes = {k: (tuple(v.shape) if not isinstance(v, dict) else
                  {kk: tuple(vv.shape) for kk, vv in v.items()})
              for k, v in shards.items()}
    return shapes, tp.gather_params(shards, rules, m)


# ---------------------------------------------------------------------- #
# the LM on a mesh
# ---------------------------------------------------------------------- #
def _cfg(cfg_kw):
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    kw = dict(cfg_kw)
    kw["dtype"] = getattr(torch, kw.get("dtype", "float32"))
    return tfm.TransformerConfig(**kw)


@case
def lm(rank, world, shape, cfg_kw, params, tokens, targets, mask=None,
       layout=None, fsdp_axis=None, steps=0, lr=0.1, optim=None):
    """The LM on this rank's blocks: the gathered logits, the loss, the
    gathered gradients, then ``steps`` train steps (SGD, or AdamW with
    ``optim``) and the gathered params after them. Rank 0 returns the
    arrays; every rank returns its losses."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    m = mesh(shape)
    cfg = _cfg(cfg_kw)
    model = tfm.params_from_jax(params, cfg, "cpu", mesh=m, layout=layout,
                                fsdp_axis=fsdp_axis)
    tok = tfm.shard_batch(tokens, cfg, m)
    tgt = tfm.shard_batch(targets, cfg, m)
    msk = None if mask is None else tfm.shard_batch(mask, cfg, m)
    with torch.no_grad():
        logits, aux = tfm.forward_with_aux(model, tok)
    full = tfm.gather_activations(logits, cfg, m, model.vocab_sharded())
    loss, grads = tfm.loss_and_grads(model, tok, tgt, msk)
    gtree = tfm.tree_to_numpy(model, grads)
    losses = []
    if optim:
        opt = torch.optim.AdamW(model.parameters(), **optim)
        step = tfm.make_optim_train_step(cfg, opt)
    else:
        step = tfm.make_train_step(cfg, lr)
    for _ in range(steps):
        losses.append(float(step(model, tok, tgt, msk)))
    after = tfm.params_to_numpy(model)
    out = {"loss": float(loss), "aux": float(aux), "losses": losses}
    if rank == 0:
        out.update(logits=full, grads=gtree, params=after)
    return out


# ---------------------------------------------------------------------- #
# expert parallelism
# ---------------------------------------------------------------------- #
@case
def moe(rank, world, shape, cfg_kw, params, x, r, batch_axis=None,
        aux_coef=0.01):
    """moe_layer on this rank's token block; this rank's share of the
    objective sum(y * r) + aux_coef * aux, whose mean over the data
    ranks is the objective: n_dp * sum(y_local * r) + aux_coef * aux (the
    port's data-axis convention). Returns (block, bounds) of y and dx, this
    rank's experts' gradients with their expert range, the router's
    gradient, aux, dropped, and each local token's chosen experts."""
    import torch
    from multiverso_tpu_torch.parallel import moe as moe_lib
    from multiverso_tpu_torch.parallel.mesh import P
    m = mesh(shape)
    cfg = moe_lib.MoEConfig(**cfg_kw)
    local = moe_lib.shard_experts(params, cfg, m)
    for v in local.values():
        v.requires_grad_()
    spec = P(batch_axis, cfg.axis, None)
    (xl, xb), (rl, _) = block(x, spec, m), block(r, spec, m)
    tx = t(xl, True)
    y, aux, dropped = moe_lib.moe_layer(tx, local, cfg, m, batch_axis)
    n_dp = m.axis_size(batch_axis) if batch_axis else 1
    (n_dp * (y * t(rl)).sum() + aux_coef * aux).backward()
    with torch.no_grad():
        probs = torch.softmax((tx.reshape(-1, cfg.dim) @ local["router"]
                               ).float(), -1)
        _, topi = moe_lib.top_k_gates(probs, cfg.top_k)
    n, i = m.axis_size(cfg.axis), m.index(cfg.axis)
    el = cfg.num_experts // n
    return {"y": (np_(y), xb), "dx": (np_(tx.grad), xb),
            "experts": (i * el, (i + 1) * el),
            "dw1": np_(local["w1"].grad), "dw2": np_(local["w2"].grad),
            "drouter": np_(local["router"].grad), "aux": float(aux),
            "dropped": float(dropped),
            "topi": (np_(topi).reshape(xl.shape[0], xl.shape[1], -1), xb)}


# ---------------------------------------------------------------------- #
# pipeline parallelism
# ---------------------------------------------------------------------- #
@case
def pp_apply(rank, world, shape, params, x, r, n_micro=2, batch_axis=None,
             interleaved=False):
    """pipeline_apply (or the interleaved schedule) of tanh(x @ w + b)
    stages; the objective sum(y * r). Returns (block, bounds) of y and dx,
    and this rank's stage gradients with their stage indices."""
    import torch
    from multiverso_tpu_torch.parallel import pipeline as pp
    from multiverso_tpu_torch.parallel.mesh import P
    m = mesh(shape)
    n = m.axis_size("pp")
    if interleaved:
        local = pp.shard_stages_interleaved(params, n, "pp", m)
    else:
        local = pp.shard_stages(params, "pp", m)
    for v in local.values():
        v.requires_grad_()
    spec = P(batch_axis)
    (xl, xb), (rl, _) = block(x, spec, m), block(r, spec, m)
    tx = t(xl, True)

    def stage_fn(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    if interleaved:
        y = pp.pipeline_apply_interleaved(stage_fn, local, tx, "pp", m,
                                          batch_axis)
    else:
        y = pp.pipeline_apply(stage_fn, local, tx, n_micro, "pp", m,
                              batch_axis)
    (y * t(rl)).sum().backward()
    i = m.index("pp")
    return {"y": (np_(y), xb), "dx": (np_(tx.grad), xb), "stage": i,
            "dw": np_(local["w"].grad[0]), "db": np_(local["b"].grad[0])}


@case
def lm_pp(rank, world, shape, cfg_kw, params, tokens, targets, n_micro,
          lr=0.05, steps=1, optim=None):
    """make_pp_train_step (or make_pp_optim_train_step with AdamW's
    ``optim``) on this rank's stage (and tensor block): the losses and
    the gathered, unstacked params after the steps."""
    import torch
    from multiverso_tpu_torch.models import transformer as tfm
    m = mesh(shape)
    cfg = _cfg(cfg_kw)
    n = m.axis_size("pp")
    stacked = tfm.shard_params_pp(tfm.stack_pp_params(params, cfg, n), m,
                                  "pp", cfg)
    tok = tfm.shard_batch(tokens, cfg, m)
    tgt = tfm.shard_batch(targets, cfg, m)
    if optim:
        opt = torch.optim.AdamW(tfm.pp_leaves(stacked), **optim)
        step = tfm.make_pp_optim_train_step(cfg, n_micro, opt, "pp", m)
    else:
        step = tfm.make_pp_train_step(cfg, n_micro, lr, "pp", m)
    losses = []
    for _ in range(steps):
        stacked, loss = step(stacked, tok, tgt)
        losses.append(float(loss))
    back = tfm.unstack_pp_params(tfm.pp_tree_to_numpy(stacked, cfg, m),
                                 cfg)
    return {"losses": losses, "params": back if rank == 0 else None}


# ---------------------------------------------------------------------- #
# BSP worker_step
# ---------------------------------------------------------------------- #
@case
def bsp_least_squares(rank, world, workers, x, y, steps, lr=0.1):
    """worker_step on linear least squares: each worker its batch shard,
    the table an 8-float SGD ArrayTable; returns the table and the losses."""
    import torch
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.parallel import worker_map
    m = worker_map.make_worker_mesh(workers, device="cpu")
    mv.init(device="cpu", mesh=m)
    try:
        table = mv.ArrayTable(8, updater="sgd", name="bsp")
        n, i = m.axis_size("worker"), m.index("worker")
        c = x.shape[0] // n
        xb, yb = t(x[i * c:(i + 1) * c]), t(y[i * c:(i + 1) * c])

        def grad_fn(params, batch):
            bx, by = batch
            w = params[:4]
            pred = bx @ w
            loss = torch.mean((pred - by) ** 2)
            g = torch.zeros_like(params)
            g[:4] = 2 * (bx.t() @ (pred - by)) / bx.shape[0]
            return loss, g

        step = worker_map.worker_step(table, grad_fn, learning_rate=lr)
        state = table.state
        losses = []
        for _ in range(steps):
            state, loss = step(state, (xb, yb))
            losses.append(float(loss))
        table.adopt(state)
        return {"table": table.get()[:8], "losses": losses}
    finally:
        mv.shutdown()


# ---------------------------------------------------------------------- #
# the collectives on CUDA tensors (tests/test_torch_kernels_cuda.py)
# ---------------------------------------------------------------------- #
def cuda_collectives(rank, world, dev):
    """Every collective on CUDA tensors of this rank (world 2 on one card
    over gloo), the values against their arithmetic, and which ops ran on
    host copies. Called by ``parallel.mesh.spawn``."""
    import torch
    from multiverso_tpu_torch import parallel
    from multiverso_tpu_torch.parallel import collectives as coll
    from multiverso_tpu_torch.telemetry import devstats
    coll.reset_staged_counts()
    devstats.reset()
    from multiverso_tpu_torch.parallel.mesh import Mesh
    m = Mesh({"mv": world}, device=dev)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 100 * rank
    out = {
        "all_reduce": parallel.all_reduce(x, "mv", m).cpu().numpy(),
        "all_gather": parallel.all_gather(x, "mv", m).cpu().numpy(),
        "reduce_scatter": parallel.reduce_scatter(x, "mv", m).cpu().numpy(),
        "broadcast": parallel.broadcast(x, 1, "mv", m).cpu().numpy(),
        "all_to_all": coll.raw_all_to_all(x.reshape(world, -1), m, "mv", 0,
                                          0).cpu().numpy(),
        "ppermute": coll.raw_ppermute(x, m, "mv", coll.ring_perm(
            world)).cpu().numpy(),
    }
    # a backward through the staged op: ppermute's gradient returns home
    xg = x.clone().requires_grad_()
    coll.ppermute(xg, m, "mv", coll.ring_perm(world)).sum().backward()
    out["ppermute_grad"] = xg.grad.cpu().numpy()
    out["on_cuda"] = all(t.is_cuda for t in (x, xg.grad))
    out["staged"] = coll.staged_counts()
    out["transfers"] = (devstats.stats_snapshot() or {}).get("transfers")
    return out


@case
def loaded_modules(rank, world):
    """Whether jax or a module of multiverso_tpu was ever imported here."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "multiverso_tpu" or m.startswith("multiverso_tpu."))
