"""The port stands alone: multiverso_tpu_torch and chip_smoke.py import
neither jax nor any module of multiverso_tpu, and the port's entry points
run on the card unless the caller asks for the CPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multiverso_tpu_torch"

_IMPORT_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_IMPORT_REF = re.compile(
    r"^\s*(import\s+multiverso_tpu(\.|\s|$|,)|from\s+multiverso_tpu(\.|\s))",
    re.M)


def _run(code: str, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import multiverso_tpu_torch as mv\n"
        "import multiverso_tpu_torch.apps.logistic_regression\n"
        "import multiverso_tpu_torch.apps.resnet_cifar\n"
        "import multiverso_tpu_torch.io.lm_data\n"
        "import multiverso_tpu_torch.models.lda\n"
        "import multiverso_tpu_torch.models.resnet\n"
        "import multiverso_tpu_torch.ops.quantization\n"
        "import multiverso_tpu_torch.apps.word_embedding\n"
        "import multiverso_tpu_torch.data.dictionary\n"
        "import multiverso_tpu_torch.elastic\n"
        "import multiverso_tpu_torch.examples.transformer_ps\n"
        "import multiverso_tpu_torch.io.mnist\n"
        "import multiverso_tpu_torch.io.realtext\n"
        "import multiverso_tpu_torch.io.sample_reader\n"
        "import multiverso_tpu_torch.io.stream\n"
        "import multiverso_tpu_torch.models.logreg\n"
        "import multiverso_tpu_torch.models.word2vec\n"
        "import multiverso_tpu_torch.ssp\n"
        "import multiverso_tpu_torch.tables.sparse_matrix_table\n"
        "import multiverso_tpu_torch.utils.async_buffer\n"
        "import multiverso_tpu_torch.utils.config\n"
        "import multiverso_tpu_torch.native\n"
        "import multiverso_tpu_torch.tables.kv_table\n"
        "import multiverso_tpu_torch.tables.matrix_table\n"
        "import multiverso_tpu_torch.models.transformer\n"
        "import multiverso_tpu_torch.ops.attention_kernels\n"
        "import multiverso_tpu_torch.ops.row_assemble\n"
        "import multiverso_tpu_torch.ops._build\n"
        "import multiverso_tpu_torch.parallel.ring\n"
        "import multiverso_tpu_torch.serving.hotcache\n"
        "import multiverso_tpu_torch.ops.wire_codec\n"
        "import multiverso_tpu_torch.utils.filters\n"
        "import multiverso_tpu_torch.utils.linkprobe\n"
        "import multiverso_tpu_torch.ps\n"
        "import multiverso_tpu_torch.ps.service\n"
        "import multiverso_tpu_torch.ps.shard\n"
        "import multiverso_tpu_torch.ps.tables\n"
        "import multiverso_tpu_torch.ps.wire\n"
        "import multiverso_tpu_torch.ops.spmd_apply\n"
        "import multiverso_tpu_torch.utils.retry\n"
        "import multiverso_tpu_torch.examples.we_async\n"
        "import multiverso_tpu_torch.serving\n"
        "import multiverso_tpu_torch.serving.admission\n"
        "import multiverso_tpu_torch.serving.replica\n"
        "import multiverso_tpu_torch.serving.pool\n"
        "import multiverso_tpu_torch.telemetry.hotkeys\n"
        "import multiverso_tpu_torch.models.dlrm\n"
        "import multiverso_tpu_torch.apps.dlrm_serving\n"
        "import multiverso_tpu_torch.examples.we_f32_error\n"
        "import chip_smoke\n"
        "multiverso_tpu_torch.native.available()   # builds and loads\n"
        "bad = [m for m in sys.modules if m == 'multiverso_tpu'\n"
        "       or m.startswith('multiverso_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_sources_import_no_jax_and_no_reference_module():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert not _IMPORT_JAX.search(text), f"{f} imports jax"
        assert not _IMPORT_REF.search(text), f"{f} imports multiverso_tpu"
    # the scan itself catches what it must
    assert _IMPORT_JAX.search("x = 1\nimport jax.numpy as jnp\n")
    assert _IMPORT_REF.search("from multiverso_tpu.zoo import Zoo\n")
    assert _IMPORT_REF.search("import multiverso_tpu as mv\n")
    assert not _IMPORT_REF.search("import multiverso_tpu_torch as mv\n")
    assert not _IMPORT_REF.search("from multiverso_tpu_torch.ops import x\n")


def test_init_without_device_needs_the_card(monkeypatch):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.utils import config
    from multiverso_tpu_torch.zoo import Zoo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mv.init()
    assert not Zoo.get().started
    with pytest.raises(RuntimeError):
        mv.init(device="cuda")
    try:
        mv.init(["-device=cpu"])
        assert mv.device() == torch.device("cpu")
    finally:
        Zoo.get().stop()
        config.reset_flags()


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
