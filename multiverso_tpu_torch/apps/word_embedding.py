"""WordEmbedding application, distributed word2vec (port of
``multiverso_tpu/apps/word_embedding.py``: skip-gram and CBOW, negative
sampling and hierarchical softmax, the fused path and the PS block path).

* min_count vocab pruning, stopword filtering (-stopwords 1 -sw_file),
  frequent-word subsampling and the dynamic window, on the host: the native
  ``csrc/mv_data.cpp`` when a C++ compiler builds it, else numpy
  (``native.available()`` says which)
* the embedding tables are :class:`MatrixTable`\\ s on the card
  (``embed_in`` uniform +-0.5/size from ``seed + 17``, ``embed_out``
  zero, and with -hs 1 ``embed_hs``, the V-1 Huffman inner nodes, zero),
  the trained-word count a :class:`KVTable`
* ``train_fused``: the batches (skip-gram's (center, context) pairs,
  CBOW's (windows, masks, targets)) are made once per corpus and kept on
  the device (a bounded LRU, flag ``we_pair_cache_corpora``; the JAX app
  caches the pairs and uploads the CBOW batches at every call, which
  changes no result); each epoch trains the tables in place, batch after
  batch, and the loss is read back once at the end. Five epochs, the JAX
  app's branches: skip-gram with a shared negative pool
  (``-shared_negatives`` > 0, the default; its products run in bf16 on the
  card, as the JAX package's do on its accelerator, and in f32 on the
  CPU), skip-gram with per-pair negatives (``-shared_negatives 0``),
  skip-gram HS (``-hs 1``), CBOW NS (``-cbow 1``) and CBOW HS (``-cbow 1
  -hs 1``). The last four compute in f32 everywhere, as the JAX epochs
  do, and the per-pair negatives follow jax.random's threefry stream from
  ``seed`` bit for bit
* ``train_ps_blocks`` (``-use_ps 1``): the reference's block flow
  (distributed_wordembedding.cpp:147-252). Per data block the worker pulls
  the block's rows, trains them locally minibatch after minibatch (the
  four variants' steps, per-pair negatives from ``splitmix32`` counters)
  and pushes the (new - old) deltas. Producer threads prepare the blocks
  ahead (``io/sample_reader.BlockPrepareQueue``, flags
  ``we_prepare_depth`` and ``we_prepare_threads``). One worker on the
  sync tables takes the device plane: the pull is a gather on the card,
  the push ``functional_add_rows``, and the negatives are derived on the
  card from the block's 4-byte seed. Otherwise (``-ps_device_plane 0``, or
  several workers) the host plane pulls with ``get_rows_async`` and pushes
  ``(new - old) / num_workers`` with ``add_rows_async``, each pull
  dispatched before the previous block's push (the reference's one-block
  staleness), pipelined or inline (``-pipeline 0``), with the same results.
  With the hot-row train cache (``-train_cache_rows N``), a block whose
  rows are all cached is pulled as a device block from the cache's
  mirror (``MatrixTable.train_cache_device_block``), with the same results
* ``-async_ps 1`` swaps in the uncoordinated tables of ``ps/``
  (``AsyncMatrixTable``, ``AsyncKVTable``; shards on this process's
  device, other ranks over TCP, ``ps_world``/``ps_rank``/
  ``ps_rendezvous``): ``train_ps_blocks`` runs the host plane against
  them, each rank training ``blocks[rank::world]`` (or, with
  ``-data_presplit 1``, every block of the corpus it was given) and
  pushing ``(new - old) / world``. ``train_fused`` trains the sync
  tables in place and refuses the async ones
* text and binary (-binary 1) embedding output, a round-tripping loader,
  words/sec reporting

Usage: ``python -m multiverso_tpu_torch.apps.word_embedding -train_file
f.txt -output vec.txt -size 128 -cbow 1 -hs 1 ...`` (argv keys mirror ref
util.cpp ParseArgs; ``-use_ps 1`` trains through the PS block path;
``-device=cpu`` runs on the CPU).
"""

from __future__ import annotations

import sys
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch import native
from multiverso_tpu_torch.data.dictionary import Dictionary, build_huffman
from multiverso_tpu_torch.io.sample_reader import BlockPrepareQueue
from multiverso_tpu_torch.models import word2vec as w2v
from multiverso_tpu_torch.ops import row_assemble as _rowasm
from multiverso_tpu_torch.tables.matrix_table import _bucket_size
from multiverso_tpu_torch.utils import config, log, threefry
from multiverso_tpu_torch.utils.dashboard import monitor

config.define_int(
    "we_prepare_depth", 4,
    "WordEmbedding prepared-block queue depth (blocks produced but not "
    "yet trained, both PS planes): bounds host prep memory while letting "
    "the producers run ahead of the consumer")
config.define_int(
    "we_prepare_threads", 2,
    "producer threads feeding the WordEmbedding prepared-block queue "
    "(pair generation, negative sampling, remap and packing run there, "
    "off the training thread)")
config.define_int(
    "we_pair_cache_corpora", 4,
    "bounded LRU capacity (corpora) of the fused path's device-resident "
    "batch cache")


def _gen_pairs(ids: np.ndarray, window: int, seed: int):
    """Prefer the native C++ pair generator; fall back to numpy."""
    if native.available():
        return native.generate_pairs(ids, window, seed=seed)
    return w2v.generate_pairs(ids, window, seed=seed)


def prepare_ids(dictionary: Dictionary, ids: np.ndarray,
                cfg: "WEConfig") -> np.ndarray:
    """The training-stream policy, shared by every entry point. Order
    matches the reference reader (reader.cpp:36-57 GetSentence): stopword
    drop first, then frequency subsampling."""
    if getattr(cfg, "stopwords", False):
        banned = np.array(
            [dictionary.word2id[w] for w in _load_stopwords(cfg.sw_file)
             if w in dictionary.word2id], np.int64)
        if banned.size:
            ids = ids[~np.isin(ids, banned)]
    if cfg.sample <= 0:
        return ids
    if native.available():
        return native.subsample(ids, dictionary.counts, cfg.sample,
                                seed=cfg.seed).astype(np.int64)
    return dictionary.subsample(ids, cfg.sample, seed=cfg.seed)


def _load_stopwords(path: str) -> set:
    """Whitespace-separated stopword list (ref reader.cpp:11-23)."""
    with open(path, "rb") as f:
        return {t.decode("utf-8", errors="replace")
                for t in f.read().split()}


def _flag(kw: dict, key: str) -> bool:
    return str(kw.get(key, "0")) in ("1", "true", "True")


class WEConfig:
    """ref util.cpp ParseArgs keys (-size -window -negative -hs -cbow
    -alpha -epoch -min_count -sample -batch_size -data_block_size), each
    parsed as the JAX package parses it, its own keys included."""

    def __init__(self, **kw):
        self.size = int(kw.get("size", 128))
        self.window = int(kw.get("window", 5))
        self.negative = int(kw.get("negative", 5))
        # >0: batch-shared negative pool of this size in the fused path
        # (gradients rescaled to the -negative objective); 0: per-pair
        self.shared_negatives = int(kw.get("shared_negatives", 64))
        self.hs = _flag(kw, "hs")
        self.cbow = _flag(kw, "cbow")
        self.alpha = float(kw.get("alpha", 0.025))
        self.epoch = int(kw.get("epoch", 1))
        self.min_count = int(kw.get("min_count", 5))
        self.sample = float(kw.get("sample", 1e-4))
        self.batch_size = int(kw.get("batch_size", 1024))
        self.data_block_size = int(kw.get("data_block_size", 100_000))
        # -use_ps 1: main trains through the PS block path
        # (train_ps_blocks) instead of the fused one
        self.use_ps = _flag(kw, "use_ps")
        # the uncoordinated async tables (not ported yet: both entry points
        # refuse it)
        self.async_ps = _flag(kw, "async_ps")
        # the PS block plane: "auto" takes the device plane when this
        # process is the only worker, "0" forces the host Get/Add plane,
        # "1" asserts the device plane
        self.ps_device_plane = str(kw.get("ps_device_plane", "auto"))
        # the block scan's compute dtype (both planes): "bf16" casts the
        # pulled rows, and the deltas are measured against the
        # bf16-rounded rows, so an untrained row's delta is exactly zero
        self.ps_block_dtype = str(kw.get("ps_block_dtype", "f32"))
        if self.ps_block_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"unknown ps_block_dtype {self.ps_block_dtype!r}")
        # host plane: "1" produces the blocks on the producer queue, "0"
        # prepares each inline (the parity oracle); the results are equal
        self.pipeline = str(kw.get("pipeline", "1")) in ("1", "true",
                                                         "True")
        self.data_presplit = _flag(kw, "data_presplit")
        self.max_vocab = kw.get("max_vocab")
        self.train_file = kw.get("train_file", "")
        # pre-counted vocabulary ("word count" lines) and its writer twin
        self.read_vocab = kw.get("read_vocab", "")
        self.save_vocab = kw.get("save_vocab", "")
        self.output = kw.get("output", "")
        # -binary 1: classic word2vec .bin output (ref util.h:26)
        self.output_binary = _flag(kw, "binary")
        # -stopwords 1 -sw_file <path>: drop listed words from the training
        # stream; the dictionary keeps them (ref reader.cpp:11-47)
        self.stopwords = _flag(kw, "stopwords")
        self.sw_file = kw.get("sw_file", "")
        if self.stopwords and not self.sw_file:
            raise ValueError("-stopwords 1 needs -sw_file (ref util.cpp:75)")
        self.seed = int(kw.get("seed", 0))

    @classmethod
    def from_argv(cls, argv: List[str]) -> "WEConfig":
        kw = {}
        i = 0
        while i < len(argv):
            a = argv[i]
            if a.startswith("-") and "=" in a:
                i += 1   # "-key=value" runtime flag: mv.init's to parse
            elif a.startswith("-") and i + 1 < len(argv):
                kw[a.lstrip("-")] = argv[i + 1]
                i += 2
            else:
                i += 1
        return cls(**kw)


class WordEmbedding:
    def __init__(self, cfg: WEConfig, dictionary: Dictionary):
        if not mv.Zoo.get().started:
            mv.init()
        self.cfg = cfg
        self.dict = dictionary
        v, d = len(dictionary), cfg.size
        if v < 2:
            raise ValueError("vocabulary too small; lower min_count")
        # input/output embedding tables (ref communicator.cpp:17-31: two
        # MatrixTables; input randomly initialized server-side). async_ps
        # swaps in the uncoordinated tables: same client API, no lockstep
        if cfg.async_ps:
            matrix, kv = mv.AsyncMatrixTable, mv.AsyncKVTable
        else:
            matrix, kv = mv.MatrixTable, mv.KVTable
        self.table_in = matrix(v, d, name="embed_in", updater="default",
                               seed=cfg.seed + 17, init_scale=0.5 / d)
        self.table_out = matrix(v, d, name="embed_out", updater="default")
        self.word_count = kv(name="word_count")
        self.unigram = dictionary.unigram_table()
        # the epoch function cfg selects, made at the first train, and the
        # shared-pool epoch's LCG state
        self._epoch = None
        self._lcg: Optional[torch.Tensor] = None
        # bounded LRU of device-resident batches, keyed by a corpus
        # fingerprint (flag we_pair_cache_corpora)
        self._pair_cache: "OrderedDict[object, tuple]" = OrderedDict()
        # the PS block path's negative table (host, and on the device)
        self._neg_host: Optional[np.ndarray] = None
        self._neg_dev: Optional[torch.Tensor] = None
        # the device plane derives each block's negatives on the device
        # from its 4-byte seed, which costs one upload of the V-id remap a
        # block: worth it unless the vocab dwarfs the block's negatives
        self._dev_negs = (not cfg.hs and cfg.negative > 0
                          and 4 * v <= cfg.data_block_size * cfg.negative)
        if cfg.hs:
            # the Huffman paths and the V-1 inner-node rows they index
            self._hs = build_huffman(dictionary.counts)
            self.table_hs = matrix(max(v - 1, 1), d, name="embed_hs",
                                   updater="default")
        else:
            self._hs = None

    # ------------------------------------------------------------------ #
    # corpus -> id stream -> device pair batches
    # ------------------------------------------------------------------ #
    def prepare_ids(self, tokens) -> np.ndarray:
        return prepare_ids(self.dict, self.dict.encode(tokens), self.cfg)

    def _batches(self, centers: np.ndarray, contexts: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        b = self.cfg.batch_size
        n = (centers.size // b) * b
        if n == 0:
            raise ValueError(
                f"corpus too small: {centers.size} pairs < batch {b}")
        return (centers[:n].reshape(-1, b), contexts[:n].reshape(-1, b))

    def _cached(self, key, make):
        """The LRU entry for ``key``, made by ``make()`` on a miss.
        Making the batches is one-time corpus preprocessing; caching them
        keeps repeat epochs off the host -> device path."""
        hit = self._pair_cache.get(key)
        if hit is not None:
            self._pair_cache.move_to_end(key)
            return hit
        hit = self._pair_cache[key] = make()
        cap = max(1, int(config.get_flag("we_pair_cache_corpora")))
        while len(self._pair_cache) > cap:
            self._pair_cache.popitem(last=False)
        return hit

    def _device_pairs(self, ids: np.ndarray):
        """(centers, contexts, pair count): the batched skip-gram pairs as
        (num_batches, batch) int64 tensors on the tables' device."""
        def make():
            centers, contexts = _gen_pairs(ids, self.cfg.window,
                                           self.cfg.seed)
            cb, xb = self._batches(centers, contexts)
            dev = self.table_in.device
            return (torch.from_numpy(cb.astype(np.int64)).to(dev),
                    torch.from_numpy(xb.astype(np.int64)).to(dev), cb.size)

        return self._cached((ids.shape, hash(ids.tobytes()), self.cfg.window,
                             self.cfg.seed, self.cfg.batch_size), make)

    def _device_cbow(self, ids: np.ndarray):
        """(windows, masks, targets, target count): the CBOW batches on the
        tables' device, (num_batches, batch, 2*window) int64 windows and
        bool masks and (num_batches, batch) int64 targets; the corpus's
        tail short of a batch is dropped, as in the JAX app."""
        def make():
            windows, masks, targets = w2v.generate_cbow_batches(
                ids, self.cfg.window)
            b = self.cfg.batch_size
            n = (targets.size // b) * b
            if n == 0:
                raise ValueError("corpus too small for batch size")
            dev = self.table_in.device
            return (torch.from_numpy(windows[:n].astype(np.int64))
                    .reshape(-1, b, windows.shape[1]).to(dev),
                    torch.from_numpy(masks[:n])
                    .reshape(-1, b, masks.shape[1]).to(dev),
                    torch.from_numpy(targets[:n].astype(np.int64))
                    .reshape(-1, b).to(dev), n)

        return self._cached(("cbow", ids.shape, hash(ids.tobytes()),
                             self.cfg.window, self.cfg.batch_size), make)

    # ------------------------------------------------------------------ #
    # fused path (device-resident training)
    # ------------------------------------------------------------------ #
    def compute_dtype(self) -> torch.dtype:
        """The shared-pool epoch's compute dtype: bf16 on the card, f32 on
        the CPU. The other epochs (per-pair, HS, CBOW) compute in the
        tables' f32 everywhere, as the JAX epochs do."""
        return (torch.bfloat16 if self.table_in.device.type == "cuda"
                else torch.float32)

    def _branch(self) -> str:
        """The JAX app's name for the epoch that cfg selects."""
        cfg = self.cfg
        if cfg.cbow:
            return "cbow_hs" if cfg.hs else "cbow"
        if cfg.hs:
            return "hs"
        return "sg_shared" if cfg.shared_negatives > 0 else "sg"

    def _epoch_fn(self):
        """The epoch function of cfg's branch, made at the first call."""
        if self._epoch is not None:
            return self._epoch
        cfg, branch = self.cfg, self._branch()
        w2v_cfg = w2v.W2VConfig(len(self.dict), cfg.size, cfg.negative,
                                cfg.window, cfg.alpha, cfg.cbow, cfg.hs,
                                cfg.shared_negatives)
        if branch == "sg_shared":
            fn = w2v.make_fused_shared_epoch(
                w2v_cfg, self.unigram, compute_dtype=self.compute_dtype())
            self._lcg = torch.from_numpy(w2v.init_lcg_state(
                cfg.shared_negatives, cfg.seed).astype(np.int64)).to(
                    self.table_in.device)
        elif branch in ("hs", "cbow_hs"):
            make = (w2v.make_fused_hs_epoch if branch == "hs"
                    else w2v.make_fused_cbow_hs_epoch)
            fn = make(w2v_cfg, *self._hs)
        else:
            make = (w2v.make_fused_epoch if branch == "sg"
                    else w2v.make_fused_cbow_epoch)
            fn = make(w2v_cfg, self.unigram)
        self._epoch = fn
        return fn

    def train_fused(self, ids: np.ndarray,
                    epochs: Optional[int] = None) -> Dict[str, float]:
        """Train ``epochs`` (default ``cfg.epoch``) epochs over ``ids`` with
        the epoch cfg selects (skip-gram or CBOW, shared-pool or per-pair
        negatives or HS). Returns the last epoch's mean loss and the run's
        words/sec (corpus tokens per second, the word2vec convention),
        seconds, pairs (CBOW: targets) and pairs/sec."""
        cfg = self.cfg
        if cfg.async_ps:
            # the fused epochs train the tables' state in place, which the
            # async tables (shards behind a wire) do not expose
            raise ValueError(
                "WordEmbedding.train_fused: async_ps=1 trains through the "
                "PS block path (train_ps_blocks, -use_ps 1); the fused "
                "epochs need the sync tables' in-place state")
        epochs = epochs or cfg.epoch
        branch = self._branch()
        t0 = time.perf_counter()
        *batches, pairs = (self._device_cbow(ids) if cfg.cbow
                           else self._device_pairs(ids))
        epoch_fn = self._epoch_fn()
        # a fresh key at every call, split once per epoch, as the JAX app
        # does: two calls of one epoch each draw the same negatives
        key = threefry.key(cfg.seed)
        out_table = self.table_hs if cfg.hs else self.table_out
        state_in, state_out = self.table_in.state, out_table.state
        # train copies, so the live tables survive a failure mid-epoch
        win, wout = state_in["data"].clone(), state_out["data"].clone()
        for _ in range(epochs):
            if branch == "sg_shared":
                win, wout, loss, self._lcg = epoch_fn(win, wout, *batches,
                                                      self._lcg)
            else:
                key, sub = threefry.split(key)
                win, wout, loss = epoch_fn(win, wout, *batches, sub)
        self.table_in.adopt({"data": win, "ustate": state_in["ustate"]})
        out_table.adopt({"data": wout, "ustate": state_out["ustate"]})
        # the loss readback is the end of the device's work
        loss_f = float(loss)
        dt = time.perf_counter() - t0
        words = epochs * int(ids.size)
        self.word_count.add([0], [words])
        return {"loss": loss_f, "words_per_sec": words / dt,
                "seconds": dt, "pairs": int(pairs),
                "pairs_per_sec": epochs * pairs / dt}

    # ------------------------------------------------------------------ #
    # PS block path (the reference's block pipeline)
    # ------------------------------------------------------------------ #
    def _use_device_plane(self, num_workers: int) -> bool:
        """One worker on the sync tables trains each block's pull, local
        train and push on the device (:meth:`_train_block_device`); several
        workers keep the host Get/Add plane."""
        mode = self.cfg.ps_device_plane
        eligible = num_workers == 1 and not self.cfg.async_ps
        if mode == "1":
            if not eligible:
                raise ValueError(
                    "ps_device_plane=1 requires a single worker on the sync "
                    "plane; multi-worker runs exchange deltas over the "
                    "Get/Add wire")
            return True
        if mode == "0":
            return False
        return eligible

    def train_ps_blocks(self, ids: np.ndarray,
                        epochs: Optional[int] = None) -> Dict[str, float]:
        """ref distributed_wordembedding.cpp:147-252: per block, pull the
        block's rows, train them locally, push the (new - old) deltas.
        Returns the mean of the blocks' losses, words/sec (corpus tokens)
        and seconds, as the JAX app does.

        Each block draws its pairs and negatives from its own child of
        ``np.random.default_rng(seed)`` (``spawn``), so producer threads
        and the inline path draw alike. The device plane (one worker)
        trains block after block on the tables' device and reads the
        blocks' losses back once, at the end. The host plane dispatches the
        pull of block N+1 before block N's push, so block N+1 trains from
        rows without block N's update: the reference's one-block staleness
        (ref :202-223), the same pipelined (``-pipeline 1``) and inline."""
        cfg = self.cfg
        epochs = epochs or cfg.epoch
        rng = np.random.default_rng(cfg.seed)
        nw, wid = self._ps_topology()
        device_plane = self._use_device_plane(nw)
        t0, losses, words = time.perf_counter(), [], 0
        dev_losses: List[torch.Tensor] = []
        blocks = [ids[lo: lo + cfg.data_block_size]
                  for lo in range(0, ids.size, cfg.data_block_size)]
        blocks = [b for b in blocks if b.size >= 2]
        # deltas are scaled by 1/nw on the multi-worker planes (ref
        # communicator.cpp:154). On the uncoordinated plane each rank
        # trains its share of the blocks, unless the caller already split
        # the corpus (-data_presplit 1); sync-table row adds would need
        # equal block counts per worker, so the split is async-only
        if nw > 1 and cfg.async_ps and not cfg.data_presplit:
            blocks = blocks[wid::nw]
        # one flat schedule across the epochs, so the next block's pull
        # overlaps the current one's training across epoch boundaries too
        schedule = [b for _ in range(epochs) for b in blocks]
        child_rngs = rng.spawn(len(schedule)) if schedule else []
        if schedule and not cfg.hs:
            self._neg_table()   # built once, before the producer threads

        def queue(produce):
            return BlockPrepareQueue(
                list(range(len(schedule))),
                lambda idx, _i: produce(schedule[idx], child_rngs[idx]),
                depth=int(config.get_flag("we_prepare_depth")),
                threads=int(config.get_flag("we_prepare_threads")))

        if device_plane and schedule:
            with queue(self._prepare_block_device) as q:
                for block in schedule:
                    prepared = q.next()
                    if prepared is not None:
                        dev_losses.append(self._train_block_device(prepared))
                    words += block.size
        elif schedule and cfg.pipeline and len(schedule) > 1:
            # the producers run the host half K blocks ahead; each pull is
            # dispatched here, at dequeue, where the inline path dispatches
            # it (before the previous block's push), so the results equal
            # the inline path's
            with queue(self._produce_block) as q:
                prepared = self._dispatch_pulls(q.next())
                for i, block in enumerate(schedule):
                    nxt = None
                    if i + 1 < len(schedule):
                        nxt = self._dispatch_pulls(q.next())
                    losses.append(self._train_prepared(prepared, nw))
                    words += block.size
                    prepared = nxt
        else:
            # the inline one-lookahead path (-pipeline 0): the parity oracle
            prepared = (self._prepare_block(schedule[0], child_rngs[0])
                        if schedule else None)
            for i, block in enumerate(schedule):
                nxt = (self._prepare_block(schedule[i + 1],
                                           child_rngs[i + 1])
                       if i + 1 < len(schedule) else None)
                losses.append(self._train_prepared(prepared, nw))
                words += block.size
                prepared = nxt
        if dev_losses:
            losses = torch.stack(dev_losses).cpu().tolist()
        # drain the in-flight pushes, so the trained state is durable when
        # the clock stops: the async tables' with an explicit flush, the
        # sync tables' on the device's stream
        for t in (self.table_in, self.table_out,
                  getattr(self, "table_hs", None)):
            if t is not None and hasattr(t, "flush"):
                t.flush()
        if self.table_in.device.type == "cuda":
            torch.cuda.synchronize(self.table_in.device)
        dt = time.perf_counter() - t0
        self.word_count.add([0], [words])
        return {"loss": float(np.mean(losses)) if losses else 0.0,
                "words_per_sec": words / dt, "seconds": dt}

    def _neg_table(self) -> np.ndarray:
        """The unigram^0.75 negative table (2^20 slots, word2vec.c's
        design), built at the first call."""
        if self._neg_host is None:
            self._neg_host = w2v.build_negative_table(self.unigram)
        return self._neg_host

    def _host_negs(self, n: int, k: int, rng) -> Tuple[np.ndarray, np.uint32]:
        """(n, k) negative ids and their 4-byte seed: slots of the table
        hashed from the counters [seed, seed + n*k) (``w2v.counter_negs``),
        so the device plane can derive the same draws on the device from
        the seed alone."""
        table = self._neg_table()
        seed = np.uint32(rng.integers(0, 1 << 32))
        idx = w2v.counter_negs(seed, max(n, 1) * k, table.size - 1)
        return (table[idx].reshape(max(n, 1), k).astype(np.int32), seed)

    def _block_arrays(self, block: np.ndarray, rng) -> Dict:
        """The host's block prep shared by both planes: the variant's
        training arrays, the block's input-vocab set, and for HS the
        block's Huffman inner-node set (ref RequestParameter's needed rows,
        communicator.cpp:104-142)."""
        cfg = self.cfg
        prep: Dict = {}
        if cfg.cbow:
            windows, masks, targets = w2v.generate_cbow_batches(
                block, cfg.window)
            prep.update(windows=windows, masks=masks, targets=targets)
            used = [windows.reshape(-1), targets, np.zeros(1, np.int64)]
            examples = targets   # the word whose path/negatives are scored
        else:
            centers, contexts = _gen_pairs(block, cfg.window,
                                           int(rng.integers(1 << 31)))
            prep.update(centers=centers, contexts=contexts)
            used = [centers, contexts]
            examples = contexts
        prep["examples"] = examples
        if cfg.hs:
            codes, points, lengths = self._hs
            t = np.asarray(examples, np.int64)
            pmask = (np.arange(codes.shape[1])[None, :]
                     < lengths[t][:, None])
            prep.update(codes=codes[t], points=points[t], pmask=pmask)
            prep["hs_rows"] = self._used_ids(
                self.table_hs.shape[0], [prep["points"][pmask]])
        else:
            negs, neg_seed = self._host_negs(examples.size, cfg.negative, rng)
            prep.update(negs=negs, neg_seed=neg_seed)
            used.append(negs.reshape(-1))
        prep["vocab"] = self._used_ids(len(self.dict), used)
        return prep

    @staticmethod
    def _used_ids(limit: int, arrays) -> np.ndarray:
        """Sorted unique ids across ``arrays`` through a presence mask,
        O(n + V) instead of np.unique's sort."""
        seen = np.zeros(limit, bool)
        for a in arrays:
            seen[np.asarray(a).reshape(-1)] = True
        return np.flatnonzero(seen)

    def _staged(self, arrays):
        """CPU tensors of ``arrays`` (a tuple of numpy arrays, or one),
        pinned when the tables are on the card, so the consumer's upload
        is asynchronous on its own stream; made on the producer thread."""
        pin = self.table_in.device.type == "cuda"

        def stage(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.pin_memory() if pin else t

        if isinstance(arrays, tuple):
            return tuple(stage(a) for a in arrays)
        return stage(arrays)

    def _upload(self, arrays):
        """The staged tensors on the tables' device, in stream order; index
        arrays (int16/int32 on the wire) become int64 there."""
        dev = self.table_in.device

        def put(t):
            t = t.to(dev, non_blocking=True)
            return t.long() if t.dtype in (torch.int16, torch.int32) else t

        if isinstance(arrays, tuple):
            return tuple(put(a) for a in arrays)
        return put(arrays)

    def _produce_block(self, block: np.ndarray, rng,
                       dispatch_early: bool = False) -> Optional[Dict]:
        """The host half of a host-plane block (pairs, negatives, remap,
        packing), safe on a producer thread: it reads no table state. The
        pulls are dispatched apart (:meth:`_dispatch_pulls`), on the
        consumer thread, in program order; the inline path
        (``dispatch_early``) dispatches them before the packing, which
        makes no table op, so the results do not change."""
        cfg = self.cfg
        b = cfg.batch_size
        with monitor("we.prepare"):
            prep = self._block_arrays(block, rng)
            n = (prep["examples"].size // b) * b
            if n == 0:
                return None
            nbb = -(-(n // b) // 8) * 8
            vocab = prep["vocab"]
            k = vocab.size
            # the pulled rows are zero-padded to a pow2 bucket, and the
            # unused slots map to a dummy row appended after it
            kb = _bucket_size(k, 1 << 30)
            remap_hs, hkb = None, 0
            if cfg.hs:
                hs_rows = prep["hs_rows"]
                hkb = _bucket_size(hs_rows.size, 1 << 30)
                remap_hs = np.full(self.table_hs.shape[0] + 1, hkb, np.int64)
                remap_hs[hs_rows] = np.arange(hs_rows.size)
            remap = np.full(len(self.dict), kb, np.int64)   # default: dummy
            remap[vocab] = np.arange(k)
            prep.update(kb=kb, hkb=hkb)
            if dispatch_early:
                self._dispatch_pulls(prep)
            batch, valid = self._pack_batches(prep, n, nbb, remap, kb,
                                              remap_hs, hkb)
            prep.update(batch=self._staged(batch), valid=valid)
            return prep

    def _dispatch_pulls(self, prep: Optional[Dict]) -> Optional[Dict]:
        """Dispatch a produced block's row pulls (ref RequestParameter,
        communicator.cpp:104-142), on the consumer thread: a pull must be
        issued before the previous block's push, where the inline path
        issues it, or the pulled rows (and so the results) would change.
        A table whose hot-row train cache holds every row of the block
        serves it as a (bucket, D) block on the device instead
        (``train_cache_device_block``: gathered and padded there, nothing
        crosses the host); otherwise ``get_rows_async``."""
        if prep is None:
            return None
        if "dev_in" in prep or "pull_in" in prep:
            return prep   # already dispatched (the inline path)

        def pull(table, ids, bucket, k_dev, k_pull):
            blk = table.train_cache_device_block(ids, bucket)
            if blk is not None:
                prep[k_dev] = blk
            else:
                prep[k_pull] = table.get_rows_async(ids)

        pull(self.table_in, prep["vocab"], prep["kb"], "dev_in", "pull_in")
        sec = ("hs_rows", "hkb") if self.cfg.hs else ("vocab", "kb")
        pull(self._sec_table(), prep[sec[0]], prep[sec[1]], "dev_sec",
             "pull_sec")
        return prep

    def _prepare_block(self, block: np.ndarray, rng) -> Optional[Dict]:
        """Inline host-plane block prep (-pipeline 0, the parity oracle):
        produce and dispatch on the calling thread."""
        return self._produce_block(block, rng, dispatch_early=True)

    def _train_prepared(self, prep: Optional[Dict],
                        num_workers: int) -> float:
        """Wait for the block's pulls, run its scan on the tables' device,
        push the (new - old) / num_workers deltas with ``add_rows_async``
        (ref communicator.cpp:144-236 AddAsync): the push overlaps the next
        block's prep. The tables' stream orders it after the next block's
        pull, which was dispatched first."""
        cfg = self.cfg
        if prep is None:
            return 0.0
        sec_t = self._sec_table()
        dev = self.table_in.device
        with monitor("we.block"):
            # the residual of the pulls dispatched a block ahead (on the
            # async plane: the sockets and the owners' serving); a
            # cache-served block is on the device already
            with monitor("we.pull_wait"):
                rows_in = (None if "dev_in" in prep
                           else self.table_in.wait(prep["pull_in"]))
                rows_sec = (None if "dev_sec" in prep
                            else sec_t.wait(prep["pull_sec"]))
            win = (prep["dev_in"] if rows_in is None
                   else _rowasm.pad_rows(rows_in, prep["kb"], dev))
            wsec = (prep["dev_sec"] if rows_sec is None
                    else _rowasm.pad_rows(
                        rows_sec, prep["hkb"] if cfg.hs else prep["kb"],
                        dev))
            d_in, d_sec, loss = self._run_block_scan(
                self._step_fn_raw(), win, wsec, prep["valid"],
                self._upload(prep["batch"]))
            d_in, d_sec = d_in.cpu().numpy(), d_sec.cpu().numpy()
        with monitor("we.push"):
            k = prep["vocab"].size
            self.table_in.add_rows_async(prep["vocab"],
                                         d_in[:k] / num_workers)
            ids_sec = prep["hs_rows"] if cfg.hs else prep["vocab"]
            sec_t.add_rows_async(ids_sec,
                                 d_sec[:ids_sec.size] / num_workers)
        return float(loss)

    def _sec_table(self):
        return self.table_hs if self.cfg.hs else self.table_out

    @staticmethod
    def _idt(limit: int):
        """Smallest index dtype covering [0, limit]: the packed batches
        cross the host -> device wire, and int16 halves the bytes."""
        return np.int16 if limit < (1 << 15) else np.int32

    def _pack_batches(self, prep: Dict, n: int, nbb: int,
                      remap: np.ndarray, dummy_in: int,
                      remap_hs: Optional[np.ndarray], dummy_hs: int,
                      dev_negs: bool = False
                      ) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
        """Remap and pack the block's training arrays into the (nbb, B,
        ...) layout of both planes, nbb a multiple of 8 (so the shapes take
        few values), and the (nbb,) valid weights: 1 for the n // B real
        minibatches, 0 for the padding. Ids are remapped into the pulled
        rows; pad slots and padded minibatches point at the dummy row after
        them, so their (masked) values never touch a real row."""
        cfg = self.cfg
        b = cfg.batch_size
        nb = n // b

        def pack(x, fill, dtype):
            out = np.full((nbb, b) + x.shape[1:], fill, dtype)
            out[:nb] = x[:n].reshape((nb, b) + x.shape[1:])
            return out

        din = self._idt(dummy_in)
        if cfg.hs:
            dhs = self._idt(dummy_hs)
            points = remap_hs[prep["points"][:n]]
            points[~prep["pmask"][:n]] = dummy_hs  # mask off-path slots
            sec_batch = (pack(prep["codes"][:n], 0, np.int8),
                         pack(points, dummy_hs, dhs),
                         pack(prep["pmask"][:n], False, bool))
        elif dev_negs:
            sec_batch = ()  # the negatives are derived on the device
        else:
            sec_batch = (pack(remap[prep["negs"][:n]], dummy_in, din),)
        if cfg.cbow:
            head = (pack(remap[prep["windows"][:n]], dummy_in, din),
                    pack(prep["masks"][:n], False, bool))
            if cfg.hs:          # cbow_hs_step(w, m, codes, points, pmask)
                batch = head + sec_batch
            else:               # cbow_ns_step(w, m, targets, negs)
                batch = head + (pack(remap[prep["targets"][:n]],
                                     dummy_in, din),) + sec_batch
        else:
            centers = pack(remap[prep["centers"][:n]], dummy_in, din)
            if cfg.hs:          # skipgram_hs_step(c, codes, points, pmask)
                batch = (centers,) + sec_batch
            else:               # skipgram_ns_step(c, contexts, negs)
                batch = (centers,
                         pack(remap[prep["contexts"][:n]], dummy_in, din),
                         ) + sec_batch
        valid = np.zeros(nbb, np.float32)
        valid[:nb] = 1.0
        return batch, valid

    def _step_fn_raw(self):
        """The minibatch step of cfg's variant (ref wordembedding.cpp
        FeedForward/HS/NS branches), trained in place by both planes."""
        cfg = self.cfg
        alpha = cfg.alpha
        if cfg.cbow and cfg.hs:
            return lambda a, s, w, m, c, p, pm: w2v.cbow_hs_step(
                a, s, w, m, c, p, pm, alpha)
        if cfg.cbow:
            return lambda a, s, w, m, t, g: w2v.cbow_ns_step(
                a, s, w, m, t, g, alpha)
        if cfg.hs:
            return lambda a, s, c, cd, p, pm: w2v.skipgram_hs_step(
                a, s, c, cd, p, pm, alpha)
        return lambda a, s, c, x, g: w2v.skipgram_ns_step(
            a, s, c, x, g, alpha)

    def _compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.cfg.ps_block_dtype == "bf16" else None

    def _run_block_scan(self, step, rows_in: torch.Tensor,
                        rows_sec: torch.Tensor, valid: np.ndarray, batch,
                        negs: Optional[torch.Tensor] = None):
        """The block's local training, both planes: the pulled rows (with
        a dummy row appended) trained minibatch after minibatch; returns
        the (new - old) deltas and the mean loss, on the rows' device.
        ``negs`` (nb, B, K), the device plane's derived negatives, is the
        step's last argument. The deltas are measured against the rows the
        scan started from, in bf16 mode the rounded ones, so a row pulled
        but not trained gets an exactly-zero delta.

        The JAX scan also runs the padded minibatches (valid 0); they touch
        only the dummy row and weigh 0 in the loss, so they are skipped."""
        cdtype = self._compute_dtype()

        def dummy(r):
            r = r.to(cdtype) if cdtype is not None else r
            return torch.cat([r, r.new_zeros((1, r.shape[1]))])

        ri, rs = dummy(rows_in), dummy(rows_sec)
        nb = int(np.count_nonzero(valid))
        losses = []
        for t in range(nb):
            arrs = tuple(a[t] for a in batch)
            if negs is not None:
                arrs = arrs + (negs[t],)
            ri, rs, loss = step(ri, rs, *arrs)
            losses.append(loss)
        loss = torch.stack(losses).float().sum() / max(nb, 1)

        def base(old):
            return old if cdtype is None else old.to(cdtype).to(old.dtype)

        d_in = ri[:-1].to(rows_in.dtype) - base(rows_in)
        d_sec = rs[:-1].to(rows_sec.dtype) - base(rows_sec)
        return d_in, d_sec, loss

    def _prepare_block_device(self, block: np.ndarray,
                              rng) -> Optional[Dict]:
        """Device-plane block prep, on a producer thread: the bucketed
        table-row ids (padded with the tables' scratch rows), the packed
        batches and, with derived negatives, the global -> local remap and
        the block's 4-byte seed, staged for one upload."""
        cfg = self.cfg
        b = cfg.batch_size
        with monitor("we.prepare"):
            prep = self._block_arrays(block, rng)
            n = (prep["examples"].size // b) * b
            if n == 0:
                return None
            nbb = -(-(n // b) // 8) * 8
            vocab = prep["vocab"]
            k = vocab.size
            vbb = _bucket_size(k, self.table_in.padded_shape[0])
            # padded ids gather the scratch row, and its zero delta
            # scatters back into it
            ids_in = np.full(vbb, self.table_in.scratch_row, np.int64)
            ids_in[:k] = vocab
            remap = np.full(len(self.dict), vbb, np.int64)  # default: dummy
            remap[vocab] = np.arange(k)
            remap_hs, hsb = None, 0
            payload = {"ids_in": ids_in}
            if cfg.hs:
                hs_rows = prep["hs_rows"]
                hk = hs_rows.size
                hsb = _bucket_size(hk, self.table_hs.padded_shape[0])
                ids_sec = np.full(hsb, self.table_hs.scratch_row, np.int64)
                ids_sec[:hk] = hs_rows
                remap_hs = np.full(self.table_hs.shape[0] + 1, hsb, np.int64)
                remap_hs[hs_rows] = np.arange(hk)
                payload["ids_sec"] = ids_sec
            batch, valid = self._pack_batches(prep, n, nbb, remap, vbb,
                                              remap_hs, hsb,
                                              dev_negs=self._dev_negs)
            payload["batch"] = batch
            if self._dev_negs:
                payload["remap"] = remap.astype(self._idt(vbb))
                payload["neg_seed"] = np.array(prep["neg_seed"], np.int64)
            return {"valid": valid,
                    **{key: self._staged(a) for key, a in payload.items()}}

    def _train_block_device(self, prep: Dict) -> torch.Tensor:
        """One block on the device: pull (a gather of the block's rows),
        local train (:meth:`_run_block_scan`), push (the deltas through
        each table's updater, ``functional_add_rows``). Returns the block's
        loss as a device scalar (read back at the end of the run)."""
        cfg = self.cfg
        t_in, t_sec = self.table_in, self._sec_table()
        p = {key: self._upload(a) for key, a in prep.items()
             if key != "valid"}
        ids_in = p["ids_in"]
        ids_sec = p.get("ids_sec", ids_in)
        negs = None
        if self._dev_negs:
            # the splitmix32 counter stream the host drew the pull set
            # from, the block's minibatches in one pass: only the 4-byte
            # seed crossed the wire
            if self._neg_dev is None:
                self._neg_dev = torch.from_numpy(
                    self._neg_table().astype(np.int64)).to(t_in.device)
            nb = int(np.count_nonzero(prep["valid"]))
            bk = cfg.batch_size * cfg.negative
            slots = w2v.counter_negs(p["neg_seed"], nb * bk,
                                     self._neg_dev.numel() - 1)
            negs = p["remap"][self._neg_dev[slots]].reshape(
                nb, cfg.batch_size, cfg.negative)
        with monitor("we.block"), t_in._dispatch_lock, t_sec._dispatch_lock:
            s_in, s_sec = t_in.state, t_sec.state
            d_in, d_sec, loss = self._run_block_scan(
                self._step_fn_raw(), s_in["data"].index_select(0, ids_in),
                s_sec["data"].index_select(0, ids_sec), prep["valid"],
                p["batch"], negs)
            t_in.functional_add_rows(s_in, ids_in, d_in)
            t_sec.functional_add_rows(s_sec, ids_sec, d_sec)
        return loss

    def _ps_topology(self) -> Tuple[int, int]:
        """(num_workers, worker_id) of the PS plane in use: the async
        context's world and rank for the uncoordinated tables; otherwise
        one process, whose logical worker count is the ``num_workers``
        flag."""
        if self.cfg.async_ps:
            ctx = self.table_in.ctx
            return max(ctx.world, 1), ctx.rank
        return max(mv.num_workers(), 1), mv.rank()

    def total_word_count(self) -> int:
        """Trained-word count across all workers (ref communicator.cpp:
        17-31, the server-aggregated KV value; an async table aggregates
        on every get)."""
        return int(self.word_count.get([0], global_=True)[0])

    # ------------------------------------------------------------------ #
    def embeddings(self) -> np.ndarray:
        return self.table_in.get()

    def nearest(self, word: str, k: int = 10) -> List[str]:
        wid = self.dict.word2id[word]
        ids = w2v.nearest_neighbors(self.embeddings(), wid, k)
        return [self.dict.words[i] for i in ids]

    def save_embeddings(self, path: Optional[str] = None,
                        binary: Optional[bool] = None) -> None:
        """ref SaveEmbedding (distributed_wordembedding.cpp:263-306):
        word2vec text format, or with -binary 1 the classic .bin layout (a
        header line, then per row ``word `` + size raw float32 +
        newline)."""
        path = path or self.cfg.output
        if not path:
            return
        binary = self.cfg.output_binary if binary is None else binary
        emb = self.embeddings()
        if binary:
            with open(path, "wb") as f:
                f.write(f"{len(self.dict)} {self.cfg.size}\n".encode())
                for w, row in zip(self.dict.words, emb):
                    f.write(w.encode() + b" "
                            + np.asarray(row, np.float32).tobytes() + b"\n")
            return
        with open(path, "w") as f:
            f.write(f"{len(self.dict)} {self.cfg.size}\n")
            for w, row in zip(self.dict.words, emb):
                f.write(w + " " + " ".join(f"{v:.6f}" for v in row) + "\n")


def load_embeddings(path: str) -> Tuple[List[str], np.ndarray]:
    """Read embeddings written by :meth:`WordEmbedding.save_embeddings`,
    text or binary, told apart by the first row (both carry the same
    ``"V D\\n"`` header). Returns (words, (V, D) float32); binary
    round-trips bit for bit."""
    with open(path, "rb") as f:
        head = f.readline().split()
        v, d = int(head[0]), int(head[1])
        rest = f.read()

    # decided once from the first row; a later parse error is a malformed
    # file and propagates instead of reinterpreting text as binary
    def _first_row_is_text() -> bool:
        try:
            nl = rest.find(b"\n")
            row = rest[: nl if nl >= 0 else len(rest)].decode(
                "utf-8", errors="strict")
            vals = np.asarray(row.split()[1:], np.float32)
            return vals.size == d
        except (ValueError, UnicodeDecodeError, IndexError):
            return False

    if _first_row_is_text():
        rows = rest.decode("utf-8").splitlines()
        if len(rows) != v:
            raise ValueError(
                f"{path}: malformed text embeddings (header says {v} "
                f"rows, file has {len(rows)})")
        twords: List[str] = []
        emb = np.empty((v, d), np.float32)
        for i, row in enumerate(rows):
            parts = row.split()
            twords.append(parts[0])
            emb[i] = np.asarray(parts[1:], np.float32)
        return twords, emb
    words: List[str] = []
    emb = np.empty((v, d), np.float32)
    off = 0
    for i in range(v):
        sp = rest.index(b" ", off)
        words.append(rest[off:sp].decode("utf-8", errors="replace"))
        start = sp + 1
        emb[i] = np.frombuffer(rest, np.float32, count=d, offset=start)
        off = start + 4 * d + 1   # skip the trailing newline
    return words, emb


def synthetic_corpus(num_tokens: int = 200_000, vocab: int = 2000,
                     seed: int = 0) -> List[str]:
    """Zipf-distributed token stream with local co-occurrence structure
    (tokens drawn in correlated runs, so nearby words share topics)."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.3, size=num_tokens) % vocab
    out = base.copy()
    pos = 0
    while pos < num_tokens:
        run = int(rng.integers(5, 50))
        topic = int(rng.integers(0, max(vocab - 50, 1)))
        out[pos: pos + run] = topic + (base[pos: pos + run] % 50)
        pos += run
    return [f"w{t}" for t in out]


def read_vocab_file(path: str, min_count: int,
                    max_vocab: Optional[int] = None) -> Dictionary:
    """Adopt a pre-counted vocabulary ("word count" lines, any order,
    re-sorted count-desc, capped at ``max_vocab``; ref
    distributed_wordembedding.cpp:415-446)."""
    items = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            c = int(parts[-1])
            if c >= min_count:
                items.append((" ".join(parts[:-1]), c))
    if not items:
        raise ValueError(f"vocab file {path} has no words >= min_count")
    items.sort(key=lambda wc: (-wc[1], wc[0]))
    if max_vocab is not None:
        items = items[:max_vocab]
    return Dictionary.from_counts([w for w, _ in items],
                                  np.array([c for _, c in items], np.int64),
                                  min_count)


def load_corpus(cfg: WEConfig) -> Tuple[Dictionary, np.ndarray]:
    """(Dictionary, training ids) for cfg.train_file, preferring the native
    one-pass loader; -read_vocab adopts a pre-counted vocabulary, and
    -save_vocab writes one. Without a train file, a synthetic corpus."""
    max_vocab = int(cfg.max_vocab) if cfg.max_vocab else None
    dictionary = None
    if cfg.read_vocab:
        dictionary = read_vocab_file(cfg.read_vocab, cfg.min_count,
                                     max_vocab)
        if cfg.train_file and native.available():
            # the native tokenizer under its own vocab, then its ids
            # remapped onto the adopted one (OOV dropped)
            corpus = native.NativeCorpus(cfg.train_file, 1, None)
            remap = np.array(
                [dictionary.word2id.get(w, -1) for w in corpus.words()],
                np.int64)
            ids = remap[corpus.ids().astype(np.int64)]
            corpus.close()
            _maybe_save_vocab(cfg, dictionary)
            return dictionary, prepare_ids(dictionary, ids[ids >= 0], cfg)
    if cfg.train_file and dictionary is None and native.available():
        corpus = native.NativeCorpus(cfg.train_file, cfg.min_count,
                                     max_vocab)
        dictionary = Dictionary.from_counts(corpus.words(), corpus.counts(),
                                            cfg.min_count)
        ids = corpus.ids().astype(np.int64)
        corpus.close()
        _maybe_save_vocab(cfg, dictionary)
        return dictionary, prepare_ids(dictionary, ids, cfg)
    if cfg.train_file:
        # byte-level ASCII-whitespace split, as the native tokenizer splits
        with open(cfg.train_file, "rb") as f:
            tokens = [t.decode("utf-8", errors="replace")
                      for t in f.read().split()]
    else:
        log.info("no -train_file given; using synthetic corpus")
        tokens = synthetic_corpus()
    if dictionary is None:
        dictionary = Dictionary.build(tokens, cfg.min_count, max_vocab)
    _maybe_save_vocab(cfg, dictionary)
    return dictionary, prepare_ids(dictionary, dictionary.encode(tokens), cfg)


def _maybe_save_vocab(cfg: WEConfig, dictionary: Dictionary) -> None:
    if not cfg.save_vocab:
        return
    with open(cfg.save_vocab, "w") as f:
        for w, c in zip(dictionary.words, dictionary.counts.tolist()):
            f.write(f"{w} {c}\n")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    # "-key=value" entries are runtime flags (-device=cpu among them), as
    # the reference's MV_Init(&argc, argv) takes them
    argv = config.consume_runtime_flags(argv)
    cfg = WEConfig.from_argv(argv)
    mv.init()
    dictionary, ids = load_corpus(cfg)
    log.info("vocab %d words, %d training tokens (native=%s)",
             len(dictionary), ids.size, native.available())
    we = WordEmbedding(cfg, dictionary)
    if cfg.use_ps:
        stats = we.train_ps_blocks(ids)
    else:
        stats = we.train_fused(ids)
    log.info("trained: %s", stats)
    we.save_embeddings()
    mv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
