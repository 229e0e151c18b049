"""Port parity: multiverso_tpu_torch's host-side WordEmbedding data pipeline
against multiverso_tpu's, on the same inputs.

Everything here is exact (no tolerance): the dictionary, the Huffman paths,
the unigram table, the real-text tokens, the native library's corpus
loader, subsampling and pairs (the same splitmix64 stream compiled from the
port's own copy of the source), and the numpy fallbacks (the same numpy
draws).
"""

import numpy as np
import pytest

from multiverso_tpu import native as jnative
from multiverso_tpu.data import dictionary as jdict
from multiverso_tpu.io import realtext as jrealtext
from multiverso_tpu.models import word2vec as jw2v
from multiverso_tpu_torch import native as tnative
from multiverso_tpu_torch.data import dictionary as tdict
from multiverso_tpu_torch.io import realtext as trealtext
from multiverso_tpu_torch.models import word2vec as tw2v


def _tokens(n=6000, vocab=120, seed=0):
    rng = np.random.default_rng(seed)
    # zipf-ish ids, with count ties (the tie order is part of the result)
    ids = rng.zipf(1.4, n) % vocab
    return [f"w{t}" for t in ids]


@pytest.mark.parametrize("min_count,max_vocab", [(1, None), (5, None),
                                                 (3, 40)])
def test_dictionary_build_encode_unigram_match_jax(min_count, max_vocab):
    toks = _tokens()
    jd = jdict.Dictionary.build(toks, min_count, max_vocab)
    td = tdict.Dictionary.build(toks, min_count, max_vocab)
    assert td.words == jd.words and td.word2id == jd.word2id
    np.testing.assert_array_equal(td.counts, jd.counts)
    assert len(td) == len(jd)
    np.testing.assert_array_equal(td.encode(toks), jd.encode(toks))
    np.testing.assert_array_equal(td.unigram_table(), jd.unigram_table())
    np.testing.assert_array_equal(td.unigram_table(0.5),
                                  jd.unigram_table(0.5))
    fc = tdict.Dictionary.from_counts(jd.words, jd.counts, min_count)
    assert fc.words == jd.words and fc.min_count == min_count


@pytest.mark.parametrize("t,seed", [(1e-3, 0), (1e-2, 5)])
def test_subsample_numpy_fallback_matches_jax(t, seed):
    toks = _tokens()
    jd, td = jdict.Dictionary.build(toks, 1), tdict.Dictionary.build(toks, 1)
    ids = jd.encode(toks)
    want = jd.subsample(ids, t, seed=seed)
    got = td.subsample(ids, t, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.size < ids.size


@pytest.mark.parametrize("vocab", [2, 3, 17, 120])
def test_huffman_matches_jax(vocab):
    counts = np.random.default_rng(vocab).integers(1, 50, vocab)
    counts[: vocab // 2] = 7     # ties
    for got, want in zip(tdict.build_huffman(counts),
                         jdict.build_huffman(counts)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tdict.build_huffman(np.array([3]))


def test_realtext_tokens_match_jax(tmp_path):
    assert trealtext.provenance() == jrealtext.provenance()
    assert trealtext.load_tokens(5000) == jrealtext.load_tokens(5000)
    path = trealtext.materialize(str(tmp_path / "rt.txt"))
    with open(path) as f:
        head = f.read(200_000).split()[:1000]
    assert head == jrealtext.load_tokens(1000)


def test_native_builds_here():
    # this machine has a C++ compiler, so the native path must be the
    # active one, as on the card's machine
    assert tnative.available() and jnative.available()
    assert tnative.library_path().parent == tnative.BUILD_DIR


@pytest.mark.parametrize("window,seed,dynamic", [(5, 0, True), (2, 9, True),
                                                 (3, 4, False)])
def test_native_pairs_match_jax_native(window, seed, dynamic):
    ids = np.random.default_rng(seed).integers(0, 300, 2000)
    got = tnative.generate_pairs(ids, window, seed=seed, dynamic=dynamic)
    want = jnative.generate_pairs(ids, window, seed=seed, dynamic=dynamic)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("t,seed", [(1e-3, 0), (1e-4, 3)])
def test_native_subsample_matches_jax_native(t, seed):
    toks = _tokens(20_000, 300)
    d = jdict.Dictionary.build(toks, 1)
    ids = d.encode(toks)
    got = tnative.subsample(ids, d.counts, t, seed=seed)
    want = jnative.subsample(ids, d.counts, t, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.size < ids.size


def test_native_corpus_matches_jax_native(tmp_path):
    path = tmp_path / "c.txt"
    path.write_text(" ".join(_tokens(5000, 80)) + "\n\tw1  w2\n")
    for min_count, max_vocab in ((1, None), (4, 30)):
        tc = tnative.NativeCorpus(str(path), min_count, max_vocab)
        jc = jnative.NativeCorpus(str(path), min_count, max_vocab)
        assert tc.vocab_size == jc.vocab_size
        assert tc.total_tokens == jc.total_tokens == 5002
        assert tc.words() == jc.words()
        np.testing.assert_array_equal(tc.counts(), jc.counts())
        np.testing.assert_array_equal(tc.ids(), jc.ids())
        tc.close()
    with pytest.raises(IOError):
        tnative.NativeCorpus(str(tmp_path / "missing.txt"))


@pytest.mark.parametrize("window,seed,dynamic", [(5, 0, True), (3, 2, False)])
def test_numpy_pairs_match_jax_numpy(window, seed, dynamic):
    ids = np.random.default_rng(1).integers(0, 100, 777).astype(np.int32)
    got = tw2v.generate_pairs(ids, window, seed=seed, dynamic=dynamic)
    want = jw2v.generate_pairs(ids, window, seed=seed, dynamic=dynamic)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    empty = tw2v.generate_pairs(ids[:1], window)
    assert empty[0].size == empty[1].size == 0


def test_without_a_compiler_the_numpy_path_is_taken(monkeypatch, tmp_path):
    from multiverso_tpu_torch.apps import word_embedding as twe
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not tnative.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.generate_pairs(np.arange(10), 2)
    ids = np.random.default_rng(2).integers(0, 50, 500)
    got = twe._gen_pairs(ids, 3, 7)
    want = jw2v.generate_pairs(ids, 3, seed=7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
