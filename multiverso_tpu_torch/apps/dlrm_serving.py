"""DLRM online serving: train-while-serve over the async PS and a read
replica (port of ``multiverso_tpu/apps/dlrm_serving.py``).

A recommender whose embedding table lives in the sharded async PS, with
TWO traffic classes hitting it at once:

* **training** (class ``"train"``): workers pull the minibatch's rows
  straight from the owning shards (read-your-writes), compute the DLRM
  loss and gradients with autograd (``models/dlrm.py``) on the client's
  device, and push the row gradients back as ``add_rows`` deltas that the
  server-side updater applies (AdaGrad by default);
* **inference** (class ``"infer"``): clients score candidates against a
  **bounded-staleness read replica** (``serving/replica.py``) instead of
  the shards — no wire hop per request, a hot-row cache on the device
  under the zipf head, and admission control shedding excess load before
  it can crowd the training writes (``serving/admission.py``).

The two classes meet only at the replica's refresh cadence (MSG_SNAPSHOT
pulls): inference QPS scales without loading the write path, at a
staleness cost that is bounded and advertised.

Not ported (ROADMAP.md §A, Telemetry and tools): the step profiler's
phases and the device-transfer counters of the JAX app.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.models import dlrm
from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
from multiverso_tpu_torch.serving.admission import AdmissionController
from multiverso_tpu_torch.serving.replica import ReadReplica
from multiverso_tpu_torch.updaters import AddOption


class DLRMServing:
    """One process's view of the train-while-serve recommender.

    The embedding table is the PS object (shared across ranks); the
    dot-interaction MLP is local to the trainer — tiny next to the
    embeddings — and inference reads it in-process. Both compute on the
    context's device (the card unless it was made for the CPU).
    ``start_replica=False`` leaves the replica in manual-refresh mode
    (tests, step-driven loops).
    """

    def __init__(self, cfg: dlrm.DLRMConfig, ctx=None,
                 name: str = "dlrm_serving", updater: str = "adagrad",
                 lr: float = 0.1, seed: int = 0,
                 infer_qps: float = 0.0,
                 cache_rows: Optional[int] = None,
                 refresh_s: Optional[float] = None,
                 staleness_s: Optional[float] = None,
                 start_replica: bool = True):
        self.cfg = cfg
        self.emb = AsyncMatrixTable(
            dlrm.total_rows(cfg), cfg.embed_dim, updater=updater,
            seed=seed, init_scale=0.05, name=f"{name}_emb", ctx=ctx)
        self.device = self.emb.device
        self.mlp = dlrm.init_mlp_params(cfg, seed, device=self.device)
        self._offsets = dlrm.field_offsets(cfg)
        self._opt = AddOption(learning_rate=lr, rho=0.1)
        self._mlp_lr = lr
        self.admission = AdmissionController()
        if infer_qps > 0:
            self.admission.set_limit(self.emb.name, "infer", infer_qps)
        # MLP updates from concurrent trainer threads apply DELTAS to the
        # current params under this lock (async SGD, as on the embedding
        # side: gradients from a pulled snapshot, applied to whatever the
        # params are now); an unguarded read-modify-write would let two
        # trainers drop each other's updates
        self._mlp_lock = threading.Lock()
        self.replica = ReadReplica(
            self.emb, admission=self.admission, cache_rows=cache_rows,
            refresh_s=refresh_s, staleness_s=staleness_s,
            start=start_replica)

    # ------------------------------------------------------------------ #
    def _ids(self, cat: np.ndarray) -> np.ndarray:
        """[B, F] per-field categorical ids -> flat global row ids in the
        one concatenated embedding table."""
        return (np.asarray(cat, np.int64)
                + self._offsets[None, :]).reshape(-1)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def train_step(self, cat, dense, labels) -> Tuple[float, float]:
        """One async-PS training step: gather the rows from the shards,
        autograd, push the row-gradient deltas (blocking — the ack means
        applied). Returns ``(loss, write_ms)``: the write latency is the
        protected metric (admission control exists so THIS number
        survives an inference storm)."""
        b, f = np.asarray(cat).shape
        ids = self._ids(cat)
        rows = self.emb.get_rows(ids).reshape(b, f, self.cfg.embed_dim)
        with self._mlp_lock:
            mlp = {k: list(v) for k, v in self.mlp.items()}
        loss, g_mlp, g_rows = dlrm.loss_and_grads(
            mlp, self._tensor(rows), self._tensor(dense),
            self._tensor(labels), self.cfg)
        with self._mlp_lock:
            self.mlp = {k: [p - self._mlp_lr * g
                            for p, g in zip(self.mlp[k], g_mlp[k])]
                        for k in self.mlp}
        g_host = g_rows.reshape(b * f, self.cfg.embed_dim).cpu().numpy()
        loss = float(loss)
        t0 = time.perf_counter()
        # duplicate ids (one user twice in a batch) accumulate in float64
        # in the client's _dedupe_batch: scatter-add semantics, as the
        # fused step's index_add_
        self.emb.add_rows(ids, g_host, self._opt)
        return loss, (time.perf_counter() - t0) * 1e3

    def infer(self, cat, dense, cls: str = "infer") -> np.ndarray:
        """Score candidates against the replica (bounded staleness; may
        shed with SheddingError under admission pressure). Returns click
        probabilities [B]."""
        b, f = np.asarray(cat).shape
        rows = self.replica.get_rows(self._ids(cat), cls=cls).reshape(
            b, f, self.cfg.embed_dim)
        with self._mlp_lock:
            mlp = self.mlp
        with torch.no_grad():
            p = torch.sigmoid(dlrm.forward(mlp, self._tensor(rows),
                                           self._tensor(dense), self.cfg))
        return p.cpu().numpy()

    def serving_stats(self) -> Dict[str, Any]:
        return self.replica.stats()

    def close(self) -> None:
        self.replica.close()
