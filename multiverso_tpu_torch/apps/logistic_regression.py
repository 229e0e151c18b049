"""LogisticRegression application (port of
``multiverso_tpu/apps/logistic_regression.py``).

The reference LR trainer (ref: Applications/LogisticRegression/ —
src/main.cpp entry, src/logreg.cpp Train/Test driver, src/configure.h
key=value config, src/model/ps_model.cpp PS sync/pipeline logic), with the
JAX app's keys and checks:

* key=value config file with the reference's keys (input_size,
  output_size, objective_type, updater_type, regular_type, minibatch_size,
  learning_rate, train_epoch, sync_frequency, pipeline, use_ps,
  reader_type, train_file, test_file, output_file)
* params in an ArrayTable; the worker premultiplies the LR and the server
  updater applies
* ``sync_frequency``: pull the model every N minibatches
  (ref ps_model.cpp DoesNeedSync :172-182)
* ``pipeline``: double-buffered async pull overlapping compute
  (ref ps_model.cpp GetPipelineTable :236-271) via AsyncBuffer
* background ring-buffer sample reader (ref reader.cpp)
* ``sparse``: a (features + 1, classes) SparseMatrixTable, pulled and
  pushed by the minibatch's active rows, with SGD or FTRL
* ``staleness``/``ssp_dir``/``heartbeat_dir``: the SSP clock

Execution paths:
* ``use_ps`` host loop — the reference flow: per minibatch the gradient
  is computed on the table's device from the host copy of the model, and
  the delta is pushed as a numpy add (coalesced by the table's applier).
* ``train_arrays`` — the fused path: minibatches already on the device,
  each step ``table.functional_add`` on the table's live state, the
  losses kept on the device and read back once. On a table sharded over
  the world's ranks, on the whole gathered state (``Table.whole_state``)
  on every rank, each keeping its block.

Entry points run on the card: ``LogReg`` starts the Zoo when it is not
started, which resolves to ``cuda`` or raises; ``-device=cpu`` on the
command line (or ``init(device="cpu")`` first) asks for the CPU.

``async_ps=true`` trains the same host loop against the uncoordinated
tables of ``ps/``: an ``AsyncArrayTable`` (dense) or an
``AsyncSparseKVTable`` keyed by feature (sparse, SGD or FTRL, whose z/n
live as shard state), whose overlapped ``get_rows_sparse_async`` pulls
the sparse lookahead runs under ``pipeline=true``.

With ``step_profile`` on, every minibatch of the host loop is one
``lr.minibatch`` step; each step consumes the current minibatch and then
fetches the next, so the reader's ``io_wait`` phase and its producer's
``io.produce`` spans land on the step they stalled or overlapped.

Usage: ``python -m multiverso_tpu_torch.apps.logistic_regression <config
file> [-flag=value ...]`` (same one-arg shape as ref src/main.cpp:7-13).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.io.sample_reader import SampleReader
from multiverso_tpu_torch.io.stream import open_stream
from multiverso_tpu_torch.models import logreg as model_lib
from multiverso_tpu_torch.telemetry import profiler as _prof
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config as config_lib
from multiverso_tpu_torch.utils import log
from multiverso_tpu_torch.utils.async_buffer import AsyncBuffer
from multiverso_tpu_torch.utils.dashboard import monitor


class LogRegConfig:
    """ref src/configure.h:9-111 key=value schema."""

    def __init__(self, pairs: Dict[str, str]):
        g = pairs.get

        def b(key, default="false"):
            # accept the same truthy spellings as the WE argv parser so
            # "-async_ps 1"-style configs behave identically across apps
            return g(key, default).lower() in ("true", "1", "yes")

        self.input_size = int(g("input_size", "0"))
        self.output_size = int(g("output_size", "2"))
        self.sparse = b("sparse")
        self.objective_type = g("objective_type", "softmax")
        self.updater_type = g("updater_type", "sgd")
        self.regular_type = g("regular_type", "none")
        self.regular_coef = float(g("regular_coef", "0.0"))
        self.minibatch_size = int(g("minibatch_size", "64"))
        self.learning_rate = float(g("learning_rate", "0.1"))
        self.train_epoch = int(g("train_epoch", "1"))
        self.sync_frequency = int(g("sync_frequency", "1"))
        # bounded staleness (SSP): -1 = off (pure async between barriers),
        # 0 = BSP lockstep, s > 0 = at most s minibatches ahead of the
        # slowest worker; needs ssp_dir on shared storage (see ssp.py).
        # heartbeat_dir additionally excludes dead workers from the bound
        # (elastic.failed); ssp_timeout bounds every wait.
        self.staleness = int(g("staleness", "-1"))
        self.ssp_dir = g("ssp_dir", "")
        self.ssp_timeout = float(g("ssp_timeout", "600"))
        self.heartbeat_dir = g("heartbeat_dir", "")
        self.pipeline = b("pipeline")
        self.use_ps = b("use_ps", "true")
        # the uncoordinated async tables (ps/) instead of the sync ones
        self.async_ps = b("async_ps")
        self.fused = b("fused")
        # reader_type accepts BOTH this app's format names (libsvm |
        # dense) and the reference's reader factory names (ref
        # reader.cpp:222-237 Get): "weight" = per-sample importance
        # weights (format follows the sparse flag), "bsparse" = binary
        # presence-only sparse records
        rt = g("reader_type", "libsvm")
        if rt == "weight":
            rt = "weight" if self.sparse else "weight_dense"
        self.reader_type = rt
        self.mnist_dir = g("mnist_dir", "")  # BASELINE config 1: idx files
        self.train_file = g("train_file", "")
        self.test_file = g("test_file", "")
        self.output_file = g("output_file", "")
        self.show_time_per_sample = int(g("show_time_per_sample", "10000"))
        if self.staleness >= 0 and not self.ssp_dir:
            raise ValueError("staleness is set but ssp_dir is empty — the "
                             "bound would be silently unenforced; set "
                             "ssp_dir to shared storage")
        if self.staleness >= 0 and not self.use_ps:
            raise ValueError("staleness needs use_ps=true (there is no "
                             "parameter server to be stale against)")
        if self.async_ps and self.mnist_dir:
            raise ValueError("async_ps trains through the use_ps host loop "
                             "(train_file=...); the mnist_dir route uses "
                             "the fused in-graph path, which async tables "
                             "do not expose")

    @classmethod
    def from_file(cls, path: str) -> "LogRegConfig":
        return cls(config_lib.parse_config_file(path))


class LogReg:
    """ref src/logreg.cpp LogReg<EleType>: config-driven trainer."""

    def __init__(self, cfg: LogRegConfig):
        if cfg.input_size <= 0:
            raise ValueError("config must set input_size")
        self.cfg = cfg
        if not mv.Zoo.get().started:
            mv.init()
        self.device = mv.device()
        n_params = model_lib.param_count(cfg.input_size, cfg.output_size)
        if cfg.sparse and cfg.async_ps:
            # the reference's flagship sparse workload: hash-keyed rows on
            # the uncoordinated plane, FTRL z/n living as shard updater
            # state (ref model/ps_model.cpp:24-41, util/sparse_table.h,
            # util/ftrl_sparse_table.h)
            self.sparse_table = mv.AsyncSparseKVTable(
                cfg.output_size, updater=cfg.updater_type,
                name="logreg_sparse", num_row=cfg.input_size + 1)
            self.table = None
        elif cfg.sparse:
            # feature-major layout: row = feature (last row = bias), col =
            # class, in a SparseMatrixTable so only active-feature rows
            # cross the wire (ref custom SparseWorkerTable + per-chunk key
            # sets, Applications/LogisticRegression/src/util/sparse_table.h)
            self.sparse_table = mv.SparseMatrixTable(
                cfg.input_size + 1, cfg.output_size,
                updater=cfg.updater_type, name="logreg_sparse")
            self.table = None
        elif cfg.async_ps:
            # the reference's default (async) server mode: deltas land on
            # the owning shard as they arrive (ref src/server.cpp:36-58)
            self.sparse_table = None
            self.table = mv.AsyncArrayTable(
                n_params, updater=cfg.updater_type, name="logreg_params")
        else:
            self.sparse_table = None
            self.table = mv.ArrayTable(n_params, updater=cfg.updater_type,
                                       name="logreg_params")
        self._local_w = np.zeros(n_params, dtype=np.float32)

    # ------------------------------------------------------------------ #
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _weights(self) -> torch.Tensor:
        """The host copy of the model, on the table's device."""
        return model_lib.unflatten(self._to_dev(self._local_w),
                                   self.cfg.input_size, self.cfg.output_size)

    def _sync_model(self) -> None:
        if self.cfg.sparse:
            # feature-major (D+1, C) -> class-major flat (C*(D+1),)
            w = self.sparse_table.get()
            self._local_w[:] = w.T.reshape(-1)
        else:
            self.table.get(out=self._local_w)

    def train_file(self) -> Dict[str, float]:
        """Epoch loop over the sample reader (ref logreg.cpp Train :41-87)."""
        cfg = self.cfg
        losses, seen, t0 = [], 0, time.perf_counter()
        pull_buffer: Optional[AsyncBuffer] = None
        if cfg.pipeline and not cfg.sparse:
            pull_buffer = AsyncBuffer(self.table.get)
        ssp_clock = None
        if cfg.staleness >= 0:
            from multiverso_tpu_torch.ssp import SSPClock
            ignore = None
            if cfg.heartbeat_dir:
                from multiverso_tpu_torch import elastic
                ignore = lambda: elastic.failed(cfg.heartbeat_dir)
            ssp_clock = SSPClock(cfg.ssp_dir, staleness=cfg.staleness,
                                 timeout=cfg.ssp_timeout, ignore=ignore)
        # the sparse path trains against the table's row ops directly —
        # _local_w is only read by test/save (which sync themselves)
        if not cfg.sparse:
            self._sync_model()
        # pipelined SPARSE pulls need a table with overlapped sparse gets
        # (the async plane's); the synchronous table's pull blocks
        sparse_pipeline = (cfg.sparse and cfg.pipeline
                           and hasattr(self.sparse_table,
                                       "get_rows_sparse_async"))
        for epoch in range(cfg.train_epoch):
            reader = SampleReader(cfg.train_file, cfg.input_size,
                                  cfg.minibatch_size, fmt=cfg.reader_type)
            batches = (self._sparse_lookahead(reader) if sparse_pipeline
                       else reader)
            # each step consumes the CURRENT minibatch and fetches the
            # NEXT one, so the reader's io_wait lands on the step it
            # stalled
            batches_it = iter(batches)
            item = next(batches_it, None)
            batch_idx = 0
            while item is not None:
                with _prof.step("lr.minibatch"):
                    if sparse_pipeline:
                        y_len = len(item["y"])
                        loss = self._train_sparse_prepared(item)
                    elif cfg.sparse:
                        x, y, keys = item
                        y_len = len(y)
                        loss = self._train_minibatch_sparse(x, y, keys)
                    else:
                        x, y, _ = item
                        y_len = len(y)
                        loss = self._train_minibatch(x, y, batch_idx,
                                                     pull_buffer)
                    item = next(batches_it, None)
                batch_idx += 1
                losses.append(float(loss))
                if ssp_clock is not None:
                    ssp_clock.tick()
                seen += y_len
                if seen % cfg.show_time_per_sample < cfg.minibatch_size:
                    log.info("epoch %d, samples %d, loss %.4f",
                             epoch, seen, losses[-1])
            mv.barrier()
            if not cfg.sparse:
                self._sync_model()
        if pull_buffer is not None:
            pull_buffer.stop()
        dt = time.perf_counter() - t0
        return {"loss": float(np.mean(losses[-10:])) if losses else 0.0,
                "samples_per_sec": seen / dt if dt > 0 else 0.0,
                "seconds": dt}

    def _train_minibatch(self, x, y, batch_idx: int,
                         pull_buffer: Optional[AsyncBuffer]) -> float:
        """ref ps_model.cpp UpdateTable :185-203 + DoesNeedSync :172-182."""
        cfg = self.cfg
        with monitor("logreg.minibatch"):
            loss, grad = model_lib.loss_and_grad(
                self._weights(), self._to_dev(x), self._to_dev(y),
                cfg.objective_type, cfg.regular_type, cfg.regular_coef)
            delta = np.zeros(self.table.size, np.float32)
            delta[: grad.numel()] = (grad.cpu().numpy().reshape(-1)
                                     * cfg.learning_rate)
            self.table.add_async(
                delta, AddOption(learning_rate=cfg.learning_rate))
            if (batch_idx + 1) % cfg.sync_frequency == 0:
                if pull_buffer is not None:
                    # double-buffer: consume the overlapped pull, kick the
                    # next
                    np.copyto(self._local_w, pull_buffer.get())
                else:
                    self._sync_model()
        return float(loss)

    def _sparse_grad(self, wsub: torch.Tensor, xa: torch.Tensor,
                     y: torch.Tensor):
        """Sparse-feature gradient: only the pulled weight rows take part
        (ref sparse LR: per-chunk key sets feed sparse pulls,
        Applications/LogisticRegression/src/reader.h:21-146)."""
        loss, diff = model_lib.objective_loss_diff(
            xa @ wsub, y, self.cfg.objective_type)        # (B, C)
        return loss, xa.T @ diff / xa.shape[0]            # (k, C)

    def _prep_sparse(self, x: np.ndarray, y: np.ndarray,
                     keys: Optional[np.ndarray], dispatch: bool) -> Dict:
        """Build the padded key set + feature submatrix for one sparse
        minibatch; with ``dispatch``, also START the stale-only pull
        (the is_pipeline overlap, ref src/table/matrix.cpp:407-418)."""
        cfg = self.cfg
        D = cfg.input_size
        with monitor("logreg.sparse_prep"):
            if keys is None:
                keys = np.nonzero(np.any(x != 0, axis=0))[0]
            keys = np.asarray(keys, dtype=np.int64).reshape(-1)
            keys_b = np.append(keys, D)              # + bias row
            k = keys_b.size
            kb = 8
            while kb < k:
                kb *= 2
            pad = kb - k
            keys_p = np.concatenate([keys_b, np.full(pad, D, np.int64)])
            # the async table's own rank is its worker (None)
            wid = None if cfg.async_ps else mv.worker_id()
            # dispatch BEFORE the xa build so the pull hides under the
            # submatrix host work
            pull = (self.sparse_table.get_rows_sparse_async(keys_p,
                                                            worker_id=wid)
                    if dispatch else None)
            # pad with the bias row; its padded xa columns are zero, so
            # the padded slots contribute exactly zero gradient
            xa = np.concatenate(
                [x[:, keys], np.ones((len(y), 1), np.float32),
                 np.zeros((len(y), pad), np.float32)], axis=1)
        return {"keys_p": keys_p, "xa": xa, "y": y, "kb": kb, "wid": wid,
                "pull": pull}

    def _train_sparse_prepared(self, prep: Dict) -> float:
        """Consume a prepared sparse minibatch: pull (or collect the
        overlapped pull), compute on the submatrix, push row deltas.
        FTRL receives the raw gradient (its alpha owns the step size,
        ref app updater.cpp FTRL branch); other updaters get lr*grad."""
        cfg = self.cfg
        with monitor("logreg.sparse_minibatch"):
            if prep["pull"] is not None:
                wsub = self.sparse_table.wait(prep["pull"])
            else:
                wsub = self.sparse_table.get_rows_sparse(
                    prep["keys_p"], worker_id=prep["wid"])
            loss, grad = self._sparse_grad(
                self._to_dev(wsub), self._to_dev(prep["xa"]),
                self._to_dev(prep["y"]))
            grad = grad.cpu().numpy()
            if self.sparse_table.updater.name != "ftrl":
                grad = grad * cfg.learning_rate
            self.sparse_table.add_rows(prep["keys_p"], grad)
        return float(loss)

    def _train_minibatch_sparse(self, x: np.ndarray, y: np.ndarray,
                                keys: Optional[np.ndarray]) -> float:
        return self._train_sparse_prepared(
            self._prep_sparse(x, y, keys, dispatch=False))

    def _sparse_lookahead(self, reader):
        """One-batch lookahead: dispatch batch N+1's sparse pull before
        training batch N (ref ps_model.cpp GetPipelineTable's double
        buffer, applied to the SPARSE path). The pull can miss batch N's
        own push — the same one-step staleness the reference's pipeline
        accepted. Runs only on a table with ``get_rows_sparse_async``."""
        prev = None
        try:
            for x, y, keys in reader:
                cur = self._prep_sparse(x, y, keys, dispatch=True)
                if prev is not None:
                    out, prev = prev, cur
                    yield out
                else:
                    prev = cur
            if prev is not None:
                out, prev = prev, None
                yield out
        finally:
            # consumer raised/abandoned us with a pull in flight: drain it
            # so the msg id doesn't sit in the table's pending map forever
            if prev is not None and prev["pull"] is not None:
                try:
                    self.sparse_table.wait(prev["pull"])
                except Exception:   # noqa: BLE001 -- the consumer's own
                    pass            # error is the one to raise

    def train_arrays(self, x: np.ndarray, y: np.ndarray,
                     epochs: Optional[int] = None) -> Dict[str, float]:
        """Fused path: every minibatch on the device, one in-place
        ``functional_add`` step each (the JAX app's ``lax.scan`` epoch).
        On a table sharded over the world's ranks every rank passes the
        same ``x`` and ``y`` (``ValueError`` otherwise, on every rank),
        trains the gathered table over the same minibatches, as the JAX
        app trains its global arrays, and keeps its block
        (``Table.whole_state``): the one-process result."""
        cfg = self.cfg
        if cfg.async_ps:
            raise ValueError("async_ps trains through the use_ps host loop "
                             "(train_file / train_minibatches); the fused "
                             "path needs the functional table plane, which "
                             "async tables do not expose")
        epochs = epochs or cfg.train_epoch
        n = (len(y) // cfg.minibatch_size) * cfg.minibatch_size
        xb = self._to_dev(x[:n]).reshape(-1, cfg.minibatch_size,
                                         cfg.input_size)
        yb = self._to_dev(y[:n]).reshape(-1, cfg.minibatch_size)
        step = model_lib.make_train_step(
            self.table, cfg.input_size, cfg.output_size, cfg.objective_type,
            cfg.regular_type, cfg.regular_coef, cfg.learning_rate)

        self.table.require_same_inputs("LogReg.train_arrays", x, y)
        t0 = time.perf_counter()
        losses = torch.empty(xb.shape[0], dtype=torch.float32,
                             device=self.device)
        with self.table.whole_state() as state:
            for _ in range(epochs):
                for i in range(xb.shape[0]):
                    state, losses[i] = step(state, (xb[i], yb[i]))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
        self._sync_model()
        return {"loss": float(torch.mean(losses[-10:])),
                "samples_per_sec": epochs * n / dt if dt > 0 else 0.0,
                "seconds": dt}

    # ------------------------------------------------------------------ #
    def test_arrays(self, x: np.ndarray, y: np.ndarray) -> float:
        """ref logreg.cpp Test :121-173 — accuracy on held-out data."""
        self._sync_model()
        return float(model_lib.accuracy(self._weights(), self._to_dev(x),
                                        self._to_dev(y)))

    def test_file(self) -> float:
        cfg = self.cfg
        correct, total = 0, 0
        reader = SampleReader(cfg.test_file, cfg.input_size,
                              cfg.minibatch_size, fmt=cfg.reader_type)
        self._sync_model()
        w = self._weights()
        for x, y, _ in reader:
            acc = float(model_lib.accuracy(w, self._to_dev(x),
                                           self._to_dev(y)))
            correct += acc * len(y)
            total += len(y)
        return correct / total if total else 0.0

    @property
    def param_table(self):
        return self.sparse_table if self.cfg.sparse else self.table

    def save_model(self, path: Optional[str] = None) -> None:
        """ref model.cpp Store :147-205 — worker-side pull then write, in
        the JAX package's checkpoint format."""
        path = path or self.cfg.output_file
        if not path:
            return
        with open_stream(path, "wb") as s:
            self.param_table.store(s)

    def load_model(self, path: str) -> None:
        with open_stream(path, "rb") as s:
            self.param_table.load(s)
        self._sync_model()


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    # "-key=value" entries are runtime flags (-device=cpu among them), as
    # the reference's MV_Init argv flow takes them (ref
    # src/multiverso.cpp:10, src/util/configure.cpp:9-54)
    rest = config_lib.consume_runtime_flags(argv)
    if len(rest) != 1:
        print("usage: python -m multiverso_tpu_torch.apps.logistic_regression"
              " <config file> [-flag=value ...]", file=sys.stderr)
        return 2
    cfg = LogRegConfig.from_file(rest[0])
    mv.init()
    if cfg.mnist_dir:
        # BASELINE config 1 (ref example/run.sh): mnist_dir=<idx dir> uses
        # real MNIST files; mnist_dir=auto takes the best REAL digit data
        # available (idx via $MV_MNIST_DIR, else sklearn's bundled UCI
        # digits — io/mnist.load_real records the provenance)
        from multiverso_tpu_torch.io import mnist
        if cfg.mnist_dir != "auto" and not mnist.available(cfg.mnist_dir):
            # explicit dir must exist — a typo'd path silently training on
            # different data would report a meaningless accuracy
            log.fatal("mnist_dir %s has no idx files (use mnist_dir=auto "
                      "for the best available real digit data)",
                      cfg.mnist_dir)
        data = mnist.load_real(
            None if cfg.mnist_dir == "auto" else cfg.mnist_dir)
        cfg.input_size = int(data["x_train"].shape[1])
        cfg.output_size = 10
        lr = LogReg(cfg)
        stats = lr.train_arrays(data["x_train"], data["y_train"])
        log.info("train done on %s: %s", data["provenance"], stats)
        log.info("test accuracy: %.4f",
                 lr.test_arrays(data["x_test"], data["y_test"]))
    else:
        if not cfg.train_file:
            log.fatal("config needs train_file=<path> (or mnist_dir=) — "
                      "nothing to train on")
        lr = LogReg(cfg)
        stats = lr.train_file()
        log.info("train done: %s", stats)
        if cfg.test_file:
            acc = lr.test_file()
            log.info("test accuracy: %.4f", acc)
    lr.save_model()
    mv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
