"""WordEmbedding application, distributed word2vec (port of
``multiverso_tpu/apps/word_embedding.py``, the fused path: skip-gram and
CBOW, negative sampling and hierarchical softmax).

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
* text and binary (-binary 1) embedding output, a round-tripping loader,
  words/sec reporting

Not ported yet (``train_fused`` raises ``NotImplementedError`` naming the
ROADMAP item): the PS block path (``use_ps``, ``train_ps_blocks``) and the
async PS tables (``async_ps``).

Usage: ``python -m multiverso_tpu_torch.apps.word_embedding -train_file
f.txt -output vec.txt -size 128 -cbow 1 -hs 1 ...`` (argv keys mirror ref
util.cpp ParseArgs; ``-device=cpu`` runs on the CPU).
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
from multiverso_tpu_torch.models import word2vec as w2v
from multiverso_tpu_torch.utils import config, log, threefry

config.define_int(
    "we_pair_cache_corpora", 4,
    "bounded LRU capacity (corpora) of the fused path's device-resident "
    "batch cache")

# what train_fused does not run yet, and the title of the ROADMAP.md §A
# item that queues it (by title: the items are renumbered as they land)
_NOT_PORTED = (
    ("use_ps", "use_ps=1 (train_ps_blocks)",
     "WordEmbedding family: train_ps_blocks"),
    ("async_ps", "async_ps=1", "the async PS (ps/)"),
)


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
        # the PS block path and its planes (not ported yet: train_fused
        # refuses use_ps and async_ps)
        self.use_ps = _flag(kw, "use_ps")
        self.async_ps = _flag(kw, "async_ps")
        self.ps_device_plane = str(kw.get("ps_device_plane", "auto"))
        self.ps_block_dtype = str(kw.get("ps_block_dtype", "f32"))
        if self.ps_block_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"unknown ps_block_dtype {self.ps_block_dtype!r}")
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
        # MatrixTables; input randomly initialized server-side)
        self.table_in = mv.MatrixTable(v, d, name="embed_in",
                                       updater="default",
                                       seed=cfg.seed + 17,
                                       init_scale=0.5 / d)
        self.table_out = mv.MatrixTable(v, d, name="embed_out",
                                        updater="default")
        self.word_count = mv.KVTable(name="word_count")
        self.unigram = dictionary.unigram_table()
        # the epoch function cfg selects, made at the first train, and the
        # shared-pool epoch's LCG state
        self._epoch = None
        self._lcg: Optional[torch.Tensor] = None
        # bounded LRU of device-resident batches, keyed by a corpus
        # fingerprint (flag we_pair_cache_corpora)
        self._pair_cache: "OrderedDict[object, tuple]" = OrderedDict()
        if cfg.hs:
            # the Huffman paths and the V-1 inner-node rows they index
            self._hs = build_huffman(dictionary.counts)
            self.table_hs = mv.MatrixTable(max(v - 1, 1), d, name="embed_hs",
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
    def _check_ported(self) -> None:
        for attr, what, item in _NOT_PORTED:
            if getattr(self.cfg, attr):
                raise NotImplementedError(
                    f"WordEmbedding.train_fused: {what} is not ported to "
                    f"multiverso_tpu_torch yet (ROADMAP.md §A {item})")

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
        self._check_ported()
        cfg = self.cfg
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

    def total_word_count(self) -> int:
        """Trained-word count across all workers (ref communicator.cpp:
        17-31, the server-aggregated KV value)."""
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
    stats = we.train_fused(ids)
    log.info("trained: %s", stats)
    we.save_embeddings()
    mv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
