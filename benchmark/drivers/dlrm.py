"""DLRM trained on the parameter tables: the port's
``models.dlrm.make_train_step`` over the embedding's ``MatrixTable`` and
the MLP's ``ArrayTable``, AdaGrad on both, one step a batch in a closed
loop.

Set-up makes both tables through the Zoo, fills the embedding on the
device from the seed (the MLP's few weights go through the table's
``init``), makes the pool of batches on the device and hands it to the
host, as a data loader hands batches over, and drives the first three
steps: they warm every shape of the window, and the readings that
``correct`` compares are taken from the tables' states. The window then
calls the step on the pool's next batch until the window's length.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark import trace, traffic
from benchmark.reference import costs
from benchmark.reference import dlrm as reference_dlrm


class Driver:
    """One run of a DLRM cell: ``setup``, ``window``, ``close``; the
    program's readings for ``correct`` in ``readings``."""

    def __init__(self, cfg: Dict, cell: Dict, seed: int, device, spans,
                 marks):
        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.tr = cell["traffic"]
        self.device = torch.device(device)
        self.spans, self.marks = spans, marks
        self.readings: Dict = {}

    def setup(self) -> None:
        self.phases = phase = trace.Phases()
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch.models import dlrm
        from multiverso_tpu_torch.updaters import AddOption
        self._mv = mv
        cfg, tr = self.cfg, self.tr
        phase("import")
        mv.init(device=str(self.device))
        phase("init")
        rows = tuple(cfg["table_rows"])
        dim = cfg["arch_sparse_feature_size"]
        bot = [int(x) for x in cfg["arch_mlp_bot"].split("-")]
        top = [int(x) for x in cfg["arch_mlp_top"].split("-")]
        self.pcfg = dlrm.DLRMConfig(vocab_sizes=rows, embed_dim=dim,
                                    dense_dim=bot[0],
                                    bottom_mlp=tuple(bot[1:]),
                                    top_mlp=tuple(top), dtype=torch.float32)
        self.n_rows = sum(rows)
        self.emb = mv.MatrixTable(self.n_rows, dim, updater="adagrad",
                                  name="dlrm_embedding")
        phase("table")
        state = self.emb.state
        with torch.no_grad():
            traffic.dlrm_table_into(cfg, self.seed,
                                    state["data"][:self.n_rows])
        self.emb.adopt(state)
        phase("table_fill")
        flat, self.meta = dlrm.flatten_mlp(
            traffic.dlrm_mlp(cfg, self.seed, self.device))
        self.flat0 = torch.from_numpy(flat)
        self.mlp = mv.ArrayTable(flat.size, updater="adagrad", init=flat,
                                 name="dlrm_mlp")
        opt = AddOption(learning_rate=tr["lr"], rho=tr["rho"])
        self.step_fn = dlrm.make_train_step(self.pcfg, self.emb, self.mlp,
                                            self.meta, opt, opt)
        phase("mlp")
        ids, dense, labels = traffic.dlrm_batches(cfg, tr, self.seed,
                                                  self.device)
        self.pool = (ids.cpu().numpy(), dense.cpu().numpy(),
                     labels.cpu().numpy())
        del ids, dense, labels
        phase("pool")
        self.es, self.ms = self.emb.state, self.mlp.state
        self.k = 0
        self.ends: List = []
        self.step_ms: List = []
        self.timing = False
        # the first three steps, on three batches of the pool
        losses = [float(self._step())]
        phase("step1")
        self.readings["grad"] = self._grad_norms()
        phase("readings")
        losses += [float(self._step()) for _ in range(2)]
        phase("steps23")
        self.readings["loss"] = losses
        self.readings["change"] = self._change_norms()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        phase("readings")

    def _mlp_leaves(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        keys, _, sizes = self.meta
        out, off = {}, 0
        names = [f"{k}.{i}" for k, n in keys for i in range(n)]
        for name, size in zip(names, sizes):
            out[name] = flat[off:off + size]
            off += size
        return out

    @torch.no_grad()
    def _grad_norms(self) -> Dict[str, float]:
        """lr * sqrt(G) of each leaf: the first gradient's norm as the
        AdaGrad state shows it after one step."""
        lr = self.tr["lr"]
        g = self.es["ustate"]["g_sqr"][:self.n_rows]
        out = {"emb": lr * float(g.sum(dtype=torch.float64).sqrt())}
        for name, h in self._mlp_leaves(self.ms["ustate"]["g_sqr"]).items():
            out[name] = lr * float(h.sum(dtype=torch.float64).sqrt())
        return out

    @torch.no_grad()
    def _change_norms(self) -> Dict[str, float]:
        """Each leaf's norm of its change since the start; the initial
        embedding is made again from the seed."""
        t0 = torch.empty((self.n_rows, self.cfg["arch_sparse_feature_size"]),
                         device=self.device)
        traffic.dlrm_table_into(self.cfg, self.seed, t0)
        t0 -= self.es["data"][:self.n_rows]
        out = {"emb": float(t0.norm())}
        del t0
        now = self._mlp_leaves(self.ms["data"])
        for name, w0 in self._mlp_leaves(self.flat0.to(self.device)).items():
            out[name] = float((now[name] - w0).norm())
        return out

    def _step(self) -> torch.Tensor:
        with self.spans("handoff"):
            i = self.k % self.tr["pool"]
            self.k += 1
            ids, dense, labels = (p[i] for p in self.pool)
        with self.spans("step"):
            a = self.marks.mark() if self.timing else None
            self.es, self.ms, loss = self.step_fn(self.es, self.ms, ids,
                                                  dense, labels)
            if self.timing:
                b = self.marks.mark()
                self.step_ms.append((a, b))
                self.ends.append(b)
        return loss

    def window(self, seconds: float) -> Dict:
        self.timing = True
        start = self.marks.mark()
        t0 = time.perf_counter()
        losses = []
        while True:
            t_step = time.perf_counter()
            losses.append(self._step())
            now = time.perf_counter()
            if now - t0 + (now - t_step) / 2 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        self.timing = False
        ends = [start] + self.ends
        b = self.tr["batch"]
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {
            "window_s": window_s,
            "steps": len(losses),
            "failed": failed,
            "examples": len(losses) * b,
            "iter_ms": [self.marks.ms(x, y) for x, y in zip(ends, ends[1:])],
            "step_ms": [self.marks.ms(x, y) for x, y in self.step_ms],
            "example_flops": costs.dlrm_example_flops(self.cfg),
        }

    def close(self) -> None:
        self.es = self.ms = self.step_fn = self.emb = self.mlp = None
        self._mv.shutdown()


def reference(cfg: Dict, cell: Dict, seed: int, device,
              mode=None, half_batch: bool = False, **kw) -> Dict:
    """The plain float32 step's readings (``reference/dlrm.run``)."""
    return reference_dlrm.run(cfg, cell, seed, device, mode, half_batch,
                              **kw)
