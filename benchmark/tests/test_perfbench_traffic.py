"""The generator: the same seed gives the same inputs, and the measured
distributions are the ones drawn."""

import json

import torch

from benchmark import traffic
from perfbench_tiny import REPO

SEED = 2 ** 33 + 5


def _cell(name):
    return json.loads((REPO / "benchmark" / "workloads"
                       / f"{name}.json").read_text())


def _config(name):
    return traffic.as_run(json.loads((REPO / "benchmark" / "configs"
                                      / f"{name}.json").read_text()))


def test_as_run_takes_the_assumed_values():
    cfg = _config("cerebras-gpt-590m")
    raw = json.loads((REPO / "benchmark" / "configs"
                      / "cerebras-gpt-590m.json").read_text())
    assert raw["torch_dtype"] == "float32" and raw["reduced"] == []
    assert cfg["torch_dtype"] == "bfloat16"
    assert cfg["layer_norm_epsilon"] == 1e-6 and cfg["n_embd"] == 1536


def test_lm_tokens_follow_the_word_counts():
    tr = dict(_cell("lm590m-local")["traffic"], pool=2, seq_len=4095)
    cfg = _config("cerebras-gpt-590m")
    a = traffic.lm_batches(cfg, tr, SEED, "cpu")
    assert torch.equal(a, traffic.lm_batches(cfg, tr, SEED, "cpu"))
    counts = traffic.word_counts(tr["unigram"], "cpu")
    share = torch.bincount(a.reshape(-1)).max().item() / a.numel()
    want = float(counts[0] / counts.sum())
    assert abs(share - want) < 0.1 * want
    assert int((torch.bincount(a.reshape(-1)) > 0).sum()) <= len(counts)


def test_dlrm_ids_are_uniform_in_each_field():
    tr = dict(_cell("dlrm-kaggle-b2048")["traffic"], pool=4)
    cfg = dict(_config("dlrm-criteo-kaggle"), table_rows=[3, 24, 5000])
    ids, _, _ = traffic.dlrm_batches(cfg, tr, SEED, "cpu")
    for f, v in enumerate(cfg["table_rows"]):
        col = ids[..., f].reshape(-1).long()
        assert 0 <= int(col.min()) and int(col.max()) < v
        seen = torch.bincount(col, minlength=v).double()
        if v <= 24:
            assert float(seen.max() / seen.mean()) < 1.2
