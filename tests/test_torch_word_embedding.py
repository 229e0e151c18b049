"""Port parity for the slice as a whole: multiverso_tpu_torch's
WordEmbedding app (the fused path: skip-gram and CBOW, shared-pool and
per-pair negatives, hierarchical softmax) against multiverso_tpu's on the
same corpus, config and seeds.

Exact: the config parsing, the corpus loading and id stream (the native
library on both sides), the initial tables, the trained-word count, and
the bytes ``save_embeddings`` writes for equal tables (text and binary).

Training: both run f32 on the CPU (the JAX package picks bf16 for the
shared pool only on a TPU, the port only on the card) with the same
batches and the same negatives (the LCG's, or jax.random's threefry
stream), so the tables differ only by the order of f32 sums inside the
products (see test_torch_word2vec.py). After 2 epochs of 141 skip-gram
batches the shared pool's tables agree to atol 2e-6 and the losses to rtol
1e-5; the other epochs state their own bounds.
"""

import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.apps import word_embedding as jwe
from multiverso_tpu_torch.apps import word_embedding as twe
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

# the slice's small config: size 16, batch 256, a pool of 32 negatives
ARGV = ["-size", "16", "-batch_size", "256", "-shared_negatives", "32",
        "-negative", "5", "-window", "3", "-min_count", "3",
        "-sample", "1e-3", "-seed", "4"]
ATOL_TABLE, RTOL_LOSS = 2e-6, 1e-5


@pytest.fixture(autouse=True)
def _both_runtimes():
    jmv.init()
    tmv.init(device="cpu")
    # one intra-op thread: an epoch here is thousands of tiny ops, and with
    # other test processes on the cores each multi-threaded op waits for
    # its threads to be scheduled (10-100x slower)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _both(argv=ARGV, tokens=None):
    tokens = tokens or twe.synthetic_corpus(12_000, vocab=300, seed=3)
    jcfg, tcfg = jwe.WEConfig.from_argv(argv), twe.WEConfig.from_argv(argv)
    jd = jwe.Dictionary.build(tokens, jcfg.min_count)
    td = twe.Dictionary.build(tokens, tcfg.min_count)
    j, t = jwe.WordEmbedding(jcfg, jd), twe.WordEmbedding(tcfg, td)
    ids = j.prepare_ids(tokens)
    np.testing.assert_array_equal(t.prepare_ids(tokens), ids)
    return j, t, ids


@pytest.mark.parametrize("argv", [
    [],
    ARGV,
    ["-cbow", "1", "-hs", "true", "-binary", "1", "-use_ps", "True",
     "-async_ps", "0", "-ps_block_dtype", "bf16", "-pipeline", "0",
     "-max_vocab", "100", "-train_file", "f.txt", "-output", "o.txt",
     "-read_vocab", "v.txt", "-save_vocab", "s.txt", "-epoch", "3",
     "-alpha", "0.05", "-data_block_size", "5000", "-data_presplit", "1",
     "-ps_device_plane", "0", "-device=cpu", "positional"],
])
def test_config_parses_like_jax(argv):
    assert (vars(twe.WEConfig.from_argv(argv))
            == vars(jwe.WEConfig.from_argv(argv)))


def test_config_errors_match_jax():
    for mod in (jwe, twe):
        with pytest.raises(ValueError, match="ps_block_dtype"):
            mod.WEConfig(ps_block_dtype="fp8")
        with pytest.raises(ValueError, match="sw_file"):
            mod.WEConfig(stopwords="1")


def test_synthetic_corpus_and_initial_tables_match_jax():
    assert (twe.synthetic_corpus(5000, 200, 1)
            == jwe.synthetic_corpus(5000, 200, 1))
    j, t, _ = _both()
    np.testing.assert_array_equal(t.embeddings(), j.embeddings())
    np.testing.assert_array_equal(t.table_out.get(), j.table_out.get())
    np.testing.assert_array_equal(t.unigram, j.unigram)
    assert t.compute_dtype() == torch.float32    # the CPU
    assert t.nearest("w3", 5) == j.nearest("w3", 5)


def test_train_fused_two_epochs_matches_jax():
    j, t, ids = _both()
    for call in range(2):
        js, ts = j.train_fused(ids, epochs=1), t.train_fused(ids, epochs=1)
        assert ts["pairs"] == js["pairs"] and ts["pairs"] > 50 * 256
        assert set(ts) == set(js)
        np.testing.assert_allclose(ts["loss"], js["loss"], rtol=RTOL_LOSS)
        np.testing.assert_allclose(t.embeddings(), j.embeddings(),
                                   rtol=0, atol=ATOL_TABLE)
        np.testing.assert_allclose(t.table_out.get(), j.table_out.get(),
                                   rtol=0, atol=ATOL_TABLE)
        np.testing.assert_array_equal(
            t._lcg.numpy(), np.asarray(j._lcg).astype(np.int64))
        assert t.total_word_count() == j.total_word_count()
        assert t.word_count.get([0]) == j.word_count.get([0])
    assert t.total_word_count() == 2 * ids.size
    assert t.word_count[0] == 2 * ids.size


def test_train_fused_epochs_argument_matches_jax():
    j, t, ids = _both()
    js, ts = j.train_fused(ids, epochs=2), t.train_fused(ids, epochs=2)
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=RTOL_LOSS)
    np.testing.assert_allclose(t.embeddings(), j.embeddings(), rtol=0,
                               atol=ATOL_TABLE)
    assert t.total_word_count() == j.total_word_count() == 2 * ids.size


def test_save_embeddings_writes_jax_bytes_and_round_trips(tmp_path):
    j, t, _ = _both()      # equal tables: the seeded init
    for binary in (False, True):
        jp, tp = tmp_path / f"j{binary}", tmp_path / f"t{binary}"
        j.save_embeddings(str(jp), binary=binary)
        t.save_embeddings(str(tp), binary=binary)
        assert tp.read_bytes() == jp.read_bytes()
        words, emb = twe.load_embeddings(str(tp))
        jwords, jemb = jwe.load_embeddings(str(tp))
        assert words == jwords == t.dict.words
        np.testing.assert_array_equal(emb, jemb)
        if binary:
            np.testing.assert_array_equal(emb, t.embeddings())
        else:
            # "%.6f": half a unit in the 6th decimal, plus the f32 parse
            np.testing.assert_allclose(emb, t.embeddings(), rtol=0,
                                       atol=5e-7 + 1e-8)
    t.save_embeddings("")      # no path: nothing written


def test_load_embeddings_rejects_a_short_text_file(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("3 2\na 0.5 1.0\nb 1.0 2.0\n")
    with pytest.raises(ValueError, match="malformed"):
        twe.load_embeddings(str(path))


def test_train_fused_under_use_ps_matches_jax():
    """use_ps=1 chooses the path in main only: train_fused trains under it
    as the JAX one does (the shared pool, to test_train_fused_two_epochs's
    bounds)."""
    j, t, ids = _both(ARGV + ["-use_ps", "1"])
    assert t.cfg.use_ps and j.cfg.use_ps
    js, ts = j.train_fused(ids), t.train_fused(ids)
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=RTOL_LOSS)
    np.testing.assert_allclose(t.embeddings(), j.embeddings(), rtol=0,
                               atol=ATOL_TABLE)
    assert t.total_word_count() == j.total_word_count() == ids.size


@pytest.mark.parametrize("extra", [
    ["-cbow", "1"], ["-hs", "1"], ["-cbow", "1", "-hs", "1"],
    ["-shared_negatives", "0"],
], ids=["cbow", "hs", "cbow_hs", "per_pair"])
def test_train_fused_variant_matches_jax(extra):
    """Two calls of one epoch each (every call starts the key afresh from
    the seed, so both draw the same negatives), f32: embed_in, the output
    table (embed_out, or embed_hs with -hs 1), the loss, the pair count
    and the word count. Tables to atol 4e-6: the largest difference
    measured is 1.6e-6, in embed_hs after the second skip-gram HS call
    (max |x| ~1.1), where the Huffman root takes every pair's update; the
    loss to rtol 1e-5 (measured <= 1.7e-7)."""
    j, t, ids = _both(ARGV + extra)
    hs = "-hs" in extra
    assert hasattr(t, "table_hs") == hs == hasattr(j, "table_hs")
    if hs:
        assert t.table_hs.shape == (len(t.dict) - 1, 16)
        for g, w in zip(t._hs, j._hs):
            np.testing.assert_array_equal(g, w)
    for call in range(2):
        js, ts = j.train_fused(ids, epochs=1), t.train_fused(ids, epochs=1)
        assert ts["pairs"] == js["pairs"] and ts["pairs"] > 20 * 256
        assert set(ts) == set(js)
        np.testing.assert_allclose(ts["loss"], js["loss"], rtol=RTOL_LOSS)
        np.testing.assert_allclose(t.embeddings(), j.embeddings(),
                                   rtol=0, atol=4e-6)
        name = "table_hs" if hs else "table_out"
        got, want = getattr(t, name).get(), getattr(j, name).get()
        assert np.abs(want).max() > 1e-2              # trained
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
        assert t.total_word_count() == j.total_word_count()
    assert t.total_word_count() == 2 * ids.size


def test_pair_cache_is_a_bounded_lru():
    j, t, ids = _both()
    tconfig.set_flag("we_pair_cache_corpora", 1)
    first = t._device_pairs(ids)
    assert t._device_pairs(ids) is first
    assert first[0].dtype == first[1].dtype == torch.int64
    other = ids[: ids.size // 2]
    t._device_pairs(other)
    assert len(t._pair_cache) == 1 and t._device_pairs(ids) is not first
    with pytest.raises(ValueError, match="corpus too small"):
        t._device_pairs(ids[:20])


def _corpus_file(tmp_path, n=20_000, vocab=400):
    path = tmp_path / "corpus.txt"
    path.write_text(" ".join(twe.synthetic_corpus(n, vocab, seed=2)))
    return path


def test_load_corpus_and_vocab_files_match_jax(tmp_path):
    path = _corpus_file(tmp_path)
    vocab = tmp_path / "vocab.txt"
    for extra in (["-save_vocab", str(vocab)], ["-read_vocab", str(vocab)],
                  ["-max_vocab", "50", "-read_vocab", str(vocab)]):
        argv = ["-train_file", str(path), "-min_count", "3"] + extra
        jd, jids = jwe.load_corpus(jwe.WEConfig.from_argv(argv))
        td, tids = twe.load_corpus(twe.WEConfig.from_argv(argv))
        assert td.words == jd.words
        np.testing.assert_array_equal(td.counts, jd.counts)
        np.testing.assert_array_equal(tids, jids)
    assert (twe.read_vocab_file(str(vocab), 3, 10).words
            == jwe.read_vocab_file(str(vocab), 3, 10).words)


@pytest.mark.parametrize("variant", [[], ["-cbow", "1", "-hs", "1"],
                                     ["-use_ps", "1",
                                      "-data_block_size", "4000"]],
                         ids=["skipgram_shared", "cbow_hs", "use_ps"])
def test_main_matches_jax(tmp_path, variant):
    path = _corpus_file(tmp_path)
    outs = {}
    for name, mod, extra in (("jax", jwe, []), ("torch", twe,
                                                ["-device=cpu"])):
        out = tmp_path / f"{name}.txt"
        argv = ["-train_file", str(path), "-output", str(out),
                "-epoch", "2"] + ARGV + variant + extra
        assert mod.main(argv) == 0
        outs[name] = out
    assert not TZoo.get().started          # main shut the port down
    jwords, jemb = jwe.load_embeddings(str(outs["jax"]))
    twords, temb = twe.load_embeddings(str(outs["torch"]))
    assert twords == jwords and temb.shape == jemb.shape == (len(jwords), 16)
    # the text file rounds to 6 decimals: one unit in the last place apart
    # where the tables differ by f32 rounding
    np.testing.assert_allclose(temb, jemb, rtol=0, atol=ATOL_TABLE + 1e-6)
