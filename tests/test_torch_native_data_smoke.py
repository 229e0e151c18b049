"""The port's data library under the sanitizers: ``csrc/mv_data_smoke.cpp``
drives every entry point of ``csrc/mv_data.cpp`` (the corpus loader, its
accessors, the subsampler, the pair generator and
``mv_parse_libsvm_line``), checks their values, and must exit 0 built
with ``-fsanitize=address,undefined`` (the JAX package's Makefile target
``sanitize`` over its own copy)."""

import os
import re
import subprocess

from multiverso_tpu_torch import native


def test_every_entry_point_is_driven():
    src = (native.CSRC / "mv_data.cpp").read_text()
    smoke = (native.CSRC / "mv_data_smoke.cpp").read_text()
    exported = set(re.findall(r"^[\w\s\*]*?\b(mv_\w+)\(", src, re.M))
    assert "mv_parse_libsvm_line" in exported and len(exported) == 11
    body = smoke[smoke.index("#define CHECK"):]   # past the declarations
    assert exported <= set(re.findall(r"\b(mv_\w+)\(", body))


def test_data_smoke_under_address_and_undefined_sanitizers(tmp_path):
    exe = tmp_path / "mv_data_smoke"
    subprocess.run(
        [os.environ.get("CXX", "g++"), "-O1", "-g", "-std=c++17", "-Wall",
         "-Werror", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-fno-omit-frame-pointer",
         "-o", str(exe), str(native.CSRC / "mv_data.cpp"),
         str(native.CSRC / "mv_data_smoke.cpp")],
        check=True, capture_output=True, timeout=240)
    corpus = tmp_path / "corpus.txt"
    res = subprocess.run([str(exe), str(corpus)], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mv_data smoke: OK" in res.stdout
    assert "runtime error" not in res.stderr   # UBSan's report
    assert not corpus.exists()                 # the smoke cleans up
