"""Port parity, the integration battery: ``python -m
multiverso_tpu_torch.harness`` against ``multiverso_tpu.harness``.

The port's battery runs on the CPU (``-device=cpu``): the whole
single-process battery, the perf entries at a small size, and kv and
matrix at ``-nprocs=2`` (two processes of one world, started by a
launcher's environment, meeting through a TCPStore over gloo), as
tests/test_harness.py runs the JAX one. Each entry asserts its own
closed forms, and each run must print the ``HARNESS PASS`` lines the JAX
harness prints for the same command. The surface is held to the JAX
module's: the same ``_TESTS`` keys, the same ``_ALL`` order, the same
flags with the same defaults except the platform ones (the JAX
``-cpu``/``-local_devices`` become the port's ``device`` flag, and the
port adds ``timeout_s``). Every subprocess here has a timeout of 120 s
or less."""

import ast
import os
import subprocess
import sys


from multiverso_tpu import harness as jax_harness
from multiverso_tpu_torch import harness as torch_harness

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "multiverso_tpu_torch.harness", *args,
         "-device=cpu"], capture_output=True, text=True, timeout=timeout,
        env=env, cwd=_REPO)


def _passes(out: str):
    return [l for l in out.splitlines() if l.startswith("HARNESS PASS")]


def test_battery_single_process(tmp_path):
    r = _run(["all", f"-checkpoint_dir={tmp_path}"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert _passes(r.stdout) == [f"HARNESS PASS {n}"
                                 for n in jax_harness._ALL], r.stdout
    times = [l.split() for l in r.stdout.splitlines()
             if l.startswith("HARNESS TIME")]
    assert [t[2] for t in times] == jax_harness._ALL
    assert all(float(t[3]) >= 0 for t in times)


def test_battery_perf_smoke():
    r = _run(["dense_perf", "sparse_perf", "-rows=512"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert _passes(r.stdout) == ["HARNESS PASS dense_perf",
                                 "HARNESS PASS sparse_perf"], r.stdout
    assert "get all rows after adding 100%" in r.stdout


def test_battery_two_process(tmp_path):
    r = _run(["kv", "matrix", "-nprocs=2", f"-checkpoint_dir={tmp_path}",
              "-timeout_s=100"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "HARNESS PASS kv (nprocs=2)" in r.stdout, r.stdout
    assert "HARNESS PASS matrix (nprocs=2)" in r.stdout, r.stdout
    # rank 0 reports each entry as it passes, as the JAX children do
    assert _passes(r.stdout) == [
        "HARNESS PASS kv", "HARNESS PASS matrix",
        "HARNESS PASS kv (nprocs=2)", "HARNESS PASS matrix (nprocs=2)"]


def test_a_rank_that_outlives_its_timeout_fails_the_run():
    r = _run(["kv", "-nprocs=2", "-timeout_s=0.5"], timeout=60)
    assert r.returncode == 1, (r.returncode, r.stdout[-1000:])
    assert "battery process 0 timed out" in r.stderr, r.stderr[-2000:]
    assert "(nprocs=2)" not in r.stdout


def test_a_failing_rank_fails_the_run(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    # checkpoint cannot create its directory under a file
    r = _run(["checkpoint", "-nprocs=2", f"-checkpoint_dir={blocker}",
              "-timeout_s=100"])
    assert r.returncode == 1, (r.returncode, r.stdout[-1000:])
    assert "battery process 0 failed" in r.stderr, r.stderr[-2000:]


def test_unknown_entry_exits_2():
    r = _run(["no_such_test"], timeout=60)
    assert r.returncode == 2
    assert "no_such_test" in r.stdout + r.stderr


def test_bare_init_smoke():
    r = _run([], timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    assert _passes(r.stdout) == ["HARNESS PASS init"]


def _defined_flags(module) -> dict:
    """name -> (define_* kind, default literal) of the module's
    ``config.define_*`` calls at its top level."""
    tree = ast.parse(open(module.__file__).read())
    out = {}
    for node in tree.body:
        call = getattr(node, "value", None)
        if (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr.startswith("define_")):
            name = ast.literal_eval(call.args[0])
            out[name] = (call.func.attr, ast.literal_eval(call.args[1]))
    return out


# the JAX harness's platform shims, replaced by the port's ``device`` flag
PLATFORM_FLAGS = {"cpu", "local_devices"}
# '' is the JAX default's directory under the process's temporary
# directory (the JAX harness writes /tmp/mv_harness_ckpt)
PORT_RESOLVED = {"checkpoint_dir": ("define_string", "")}


def test_surface_matches_the_jax_harness():
    assert list(torch_harness._TESTS) == list(jax_harness._TESTS)
    assert torch_harness._ALL == jax_harness._ALL
    jax_flags = _defined_flags(jax_harness)
    port_flags = _defined_flags(torch_harness)
    for name, (kind, default) in jax_flags.items():
        if name in PLATFORM_FLAGS:
            assert name not in port_flags
            continue
        assert port_flags[name] == PORT_RESOLVED.get(name, (kind, default)), \
            name
    assert set(port_flags) - set(jax_flags) == {"timeout_s"}
    from multiverso_tpu_torch.utils import config
    assert config.get_flag("device") == ""   # '' is the card
