"""Vocabulary dictionary and Huffman encoding (port of
``multiverso_tpu/data/dictionary.py``; host-side numpy, no torch).

Word -> id with min_count pruning, ids in count-descending order with ties
broken by the word (the reference's dictionary.cpp job), frequent-word
subsampling, the unigram^0.75 negative-sampling distribution, and the
Huffman tree over the counts as padded (codes, points, lengths) arrays for
hierarchical softmax. The same inputs give the same ids, draws and paths
as the JAX package's copy.
"""

from __future__ import annotations

import collections
import heapq
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class Dictionary:
    """Word <-> id with count-based pruning (ref dictionary.cpp)."""

    def __init__(self, min_count: int = 5):
        self.min_count = min_count
        self.word2id: Dict[str, int] = {}
        self.words: List[str] = []
        self.counts: np.ndarray = np.zeros(0, dtype=np.int64)

    @classmethod
    def from_counts(cls, words: List[str], counts: np.ndarray,
                    min_count: int = 5) -> "Dictionary":
        """Adopt a pre-counted vocabulary (e.g. from the native corpus
        loader), which is already pruned and count-desc sorted."""
        d = cls(min_count)
        d.words = list(words)
        d.word2id = {w: i for i, w in enumerate(d.words)}
        d.counts = np.asarray(counts, dtype=np.int64)
        return d

    @classmethod
    def build(cls, tokens: Iterable[str], min_count: int = 5,
              max_vocab: Optional[int] = None) -> "Dictionary":
        d = cls(min_count)
        counter = collections.Counter(tokens)
        items = [(w, c) for w, c in counter.items() if c >= min_count]
        items.sort(key=lambda wc: (-wc[1], wc[0]))
        if max_vocab is not None:
            items = items[:max_vocab]
        d.words = [w for w, _ in items]
        d.word2id = {w: i for i, w in enumerate(d.words)}
        d.counts = np.array([c for _, c in items], dtype=np.int64)
        return d

    def __len__(self) -> int:
        return len(self.words)

    def encode(self, tokens: Iterable[str]) -> np.ndarray:
        """Token stream -> id stream, dropping OOV (ref reader behavior)."""
        w2i = self.word2id
        return np.fromiter((w2i[t] for t in tokens if t in w2i),
                           dtype=np.int64)

    def subsample(self, ids: np.ndarray, t: float = 1e-4,
                  seed: int = 0) -> np.ndarray:
        """Frequent-word subsampling (ref reader.cpp sample_value): keep word w
        with prob (sqrt(f/t)+1)*t/f where f is w's corpus frequency."""
        total = self.counts.sum()
        freq = self.counts / max(total, 1)
        keep = np.minimum(1.0, (np.sqrt(freq / t) + 1) * t
                          / np.maximum(freq, 1e-12))
        rng = np.random.default_rng(seed)
        return ids[rng.random(ids.size) < keep[ids]]

    def unigram_table(self, power: float = 0.75) -> np.ndarray:
        """Negative-sampling distribution (counts^0.75, normalized)."""
        p = self.counts.astype(np.float64) ** power
        return (p / p.sum()).astype(np.float32)


def build_huffman(counts: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Huffman tree over word counts (ref huffman_encoder.cpp:BuildTree).

    Returns (codes, points, lengths):
    * codes  [V, L] int32 in {0,1}, the left/right decisions, padded with 0
    * points [V, L] int32, inner-node ids (< V-1), padded with V-2 (masked
      out by lengths)
    * lengths [V] int32, true path length per word

    L = max path length. Inner nodes are numbered 0..V-2 (the output table
    for HS has V-1 rows). Ties in the heap break on the node id, so the tree
    is the JAX package's.
    """
    vocab = int(counts.size)
    if vocab < 2:
        raise ValueError("huffman needs >= 2 words")
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = np.zeros(2 * vocab - 1, dtype=np.int64)
    binary = np.zeros(2 * vocab - 1, dtype=np.int8)
    next_id = vocab
    while len(heap) > 1:
        c1, i1 = heapq.heappop(heap)
        c2, i2 = heapq.heappop(heap)
        parent[i1] = next_id
        parent[i2] = next_id
        binary[i2] = 1
        heapq.heappush(heap, (c1 + c2, next_id))
        next_id += 1
    root = next_id - 1

    codes_list, points_list = [], []
    max_len = 0
    for w in range(vocab):
        code, point = [], []
        node = w
        while node != root:
            code.append(int(binary[node]))
            node = int(parent[node])
            point.append(node - vocab)  # inner-node id in [0, V-2]
        code.reverse()
        point.reverse()
        codes_list.append(code)
        points_list.append(point)
        max_len = max(max_len, len(code))

    codes = np.zeros((vocab, max_len), dtype=np.int32)
    points = np.full((vocab, max_len), max(vocab - 2, 0), dtype=np.int32)
    lengths = np.zeros(vocab, dtype=np.int32)
    for w in range(vocab):
        n = len(codes_list[w])
        lengths[w] = n
        codes[w, :n] = codes_list[w]
        points[w, :n] = points_list[w]
    return codes, points, lengths
