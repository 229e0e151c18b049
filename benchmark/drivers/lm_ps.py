"""An LM worker trained through the parameter server: the port's
``examples.transformer_ps.train_ps`` over a ``Transformer`` whose whole
parameter tree lives in one ``SharedPytree`` (an ``ArrayTable``).

Set-up builds the model at the configuration's widths in its dtype, fills
it on the device from the seed, puts it into the PS table, and drives the
worker's first three steps through ``train_ps`` (in a syncing cell the
third ends with a sync): they warm every shape of the window, and the
readings that ``correct`` compares are taken from their state. The window
then calls ``train_ps`` one sync period at a time (one step at a time in a
cell that never syncs), on a new batch of the pool each step. The step
function is the port's ``make_train_step``, wrapped only to take the next
batch and to time it; the sync is the table's own, wrapped only to time it.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from benchmark import trace, traffic
from benchmark.reference import costs
from benchmark.reference import lm as reference_lm

NEVER = 1 << 40


class _TimedShared:
    """The worker's ``SharedPytree``, its ``sync`` timed: the span opens at
    the sync and closes when the driver next takes control (the next step,
    or the return of ``train_ps``), after the merged weights are loaded
    and the device has drained."""

    def __init__(self, shared, driver):
        self._shared = shared
        self._driver = driver

    def sync(self, params):
        self._driver._open_sync()
        return self._shared.sync(params)


class Driver:
    """One run of an LM cell: ``setup``, ``window``, ``close``; the program's
    readings for ``correct`` in ``readings``."""

    def __init__(self, cfg: Dict, cell: Dict, seed: int, device, spans,
                 marks):
        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.tr = cell["traffic"]
        self.device = torch.device(device)
        self.spans, self.marks = spans, marks
        self.readings: Dict = {}

    # -------------------------------------------------------------- set-up
    def setup(self) -> None:
        self.phases = phase = trace.Phases()
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch.examples import transformer_ps
        from multiverso_tpu_torch.models import transformer as tfm
        from multiverso_tpu_torch.sharedvar import SharedPytree
        self._mv, self._train_ps = mv, transformer_ps.train_ps
        cfg, tr = self.cfg, self.tr
        phase("import")
        mv.init(device=str(self.device))
        phase("init")
        dtype = getattr(torch, cfg["torch_dtype"])
        self.tcfg = tfm.TransformerConfig(
            vocab_size=cfg["vocab_size"], dim=cfg["n_embd"],
            num_heads=cfg["n_head"], num_layers=cfg["n_layer"],
            max_seq=cfg["n_positions"],
            mlp_ratio=cfg["n_inner"] // cfg["n_embd"], dtype=dtype,
            attn=cfg["attn"])
        self.model = tfm.Transformer(self.tcfg, self.device)
        phase("model")
        with torch.no_grad():
            traffic.lm_weights_into(cfg, self.seed,
                                    dict(self.model.named_parameters()))
            self.pool = traffic.lm_batches(cfg, tr, self.seed, self.device)
        phase("weights_pool")
        self.shared = _TimedShared(SharedPytree(self.model, name="lm_params"),
                                   self)
        phase("shared")
        self.step_fn = tfm.make_train_step(self.tcfg, tr["lr"])
        self.lr = torch.tensor(tr["lr"], dtype=dtype).item()
        self.k = 0
        self._sync_at = None
        self._sync_span = None
        self.sync_ms: List[float] = []
        self.step_ms: List[float] = []
        self.ends: List = []
        self.timing = False
        # the first three steps, on three batches of the pool: the first
        # alone, for its gradient; in a syncing cell the third ends with
        # the sync
        tok, tgt = self.pool[0, :, :-1], self.pool[0, :, 1:]
        losses = self._train_ps(self.model, self.shared, tok, tgt, 1, NEVER,
                                tr["lr"], step_fn=self._step)
        phase("step1")
        self.readings["grad"] = self._norms(lambda w0, p: (w0 - p) / self.lr)
        phase("readings")
        losses += self._train_ps(self.model, self.shared, tok, tgt, 2,
                                 2 if tr["sync_every"] else NEVER, tr["lr"],
                                 step_fn=self._step)
        self._close_sync()
        phase("steps23_sync")
        self.readings["loss"] = losses
        self.readings["change"] = self._norms(lambda w0, p: p - w0)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        phase("readings")
        self.sync_ms.clear()

    @torch.no_grad()
    def _norms(self, fn) -> Dict[str, float]:
        """Each leaf's float32 norm of ``fn(initial, current)``; the initial
        weights are made again from the seed."""
        w0 = traffic.lm_weights(self.cfg, self.seed, self.device,
                                getattr(torch, self.cfg["torch_dtype"]))
        return {n: float(fn(w0[n].float(), p.float()).norm())
                for n, p in self.model.named_parameters()}

    # ------------------------------------------------------------ the loop
    def _open_sync(self) -> None:
        self._sync_at = time.perf_counter()
        self._sync_span = self.spans("sync")
        self._sync_span.__enter__()

    def _close_sync(self) -> None:
        if self._sync_at is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._sync_span.__exit__(None, None, None)
        self.sync_ms.append((time.perf_counter() - self._sync_at) * 1e3)
        self._sync_at = self._sync_span = None

    def _step(self, model, tokens, targets):
        self._close_sync()
        with self.spans("handoff"):
            batch = self.pool[self.k % self.tr["pool"]]
            self.k += 1
        with self.spans("step"):
            a = self.marks.mark() if self.timing else None
            loss = self.step_fn(model, batch[:, :-1], batch[:, 1:])
            if self.timing:
                b = self.marks.mark()
                self.step_ms.append((a, b))
                self.ends.append(b)
        return loss

    def window(self, seconds: float) -> Dict:
        tr = self.tr
        per_call = tr["sync_every"] or 1
        every = tr["sync_every"] or NEVER
        tok, tgt = self.pool[0, :, :-1], self.pool[0, :, 1:]
        self.timing = True
        start = self.marks.mark()
        t0 = time.perf_counter()
        losses: List[float] = []
        while True:
            t_call = time.perf_counter()
            losses += self._train_ps(self.model, self.shared, tok, tgt,
                                     per_call, every, tr["lr"],
                                     step_fn=self._step)
            self._close_sync()
            now = time.perf_counter()
            # stop at the call boundary nearest the window's length
            if now - t0 + (now - t_call) / 2 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        self.timing = False
        ends = [start] + self.ends
        b, s = tr["batch"], tr["seq_len"]
        return {
            "window_s": window_s,
            "steps": len(losses),
            "failed": sum(1 for x in losses if not math.isfinite(x)),
            "tokens": len(losses) * b * s,
            "iter_ms": [self.marks.ms(x, y) for x, y in zip(ends, ends[1:])],
            "step_ms": [self.marks.ms(x, y) for x, y in self.step_ms],
            "sync_ms": list(self.sync_ms),
            "sync_every": tr["sync_every"],
            "step_flops": costs.lm_step_flops(self.cfg, b, s),
            "attn_shape": (b, self.cfg["n_head"], s,
                           self.cfg["n_embd"] // self.cfg["n_head"]),
            "layers": self.cfg["n_layer"],
        }

    def close(self) -> None:
        self.model = self.shared = self.step_fn = self.pool = None
        self._mv.shutdown()


def reference(cfg: Dict, cell: Dict, seed: int, device,
              mode=None, half_batch: bool = False) -> Dict:
    return reference_lm.run(cfg, cell, seed, device, mode, half_batch)
