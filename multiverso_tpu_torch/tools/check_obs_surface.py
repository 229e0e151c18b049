#!/usr/bin/env python
"""Static lint of the port's observability surface (tier-1 wraps this;
the port's copy of the JAX package's ``tools/check_obs_surface.py``,
scanning ``multiverso_tpu_torch/``).

A wire opcode with no flight-recorder coverage, or a flag no operator
can find, slips because nothing asks the question at review time. This
tool asks it mechanically:

1. **Every ``MSG_*`` opcode** defined in ``ps/service.py`` /
   ``ps/wire.py`` must have an entry in
   ``telemetry/flightrec.MSG_EV_COVERAGE`` naming the ring events that
   mark its lifecycle (an explicit EMPTY tuple is allowed — probe
   traffic is deliberately off the tape — but it must be stated, not
   forgotten), and every event named must exist in ``EV_NAMES``.
2. **Every flag** registered via ``config.define_*`` anywhere under
   ``multiverso_tpu_torch/`` must appear in ``docs/TUNING.md`` (the
   knobs the port shares with the JAX package) or in the port's section
   of ``README.md`` (the port's own knobs) — a knob an operator cannot
   discover is a knob that does not exist.
3. **Every top-level key** the stats surface emits — the shard
   ``stats()`` methods, ``PSService.stats_payload``, the exporter's
   ``default_stats_fn``, and the memstats ``"memory"`` block — must be
   RENDERED by at least one of the port's ``tools/mvtop.py`` /
   ``tools/dump_metrics.py`` (its quoted name appears in their
   source), or sit on the explicit raw-key allowlist. This is the
   exact crack that would let a new stats block ship and go dark: the
   payload grows a key, no pane of glass ever shows it, and the next
   leak's evidence is emitted into the void.
4. **Every collective entry point** in ``parallel/`` records a devstats
   span (the port's ``parallel/`` holds only the attention oracle until
   the mesh slice, so this lint is trivially clean).
6. and 7. The tenant block's keys, the SLO objective kinds and the
   signal-bus names all render.

The JAX tool's lint 5 (the benchmark's regression keys against their
producers) reads ``tools/run_bench.py`` and ``bench.py``; the port has no
benchmark yet, so the lint waits for it (ROADMAP.md).

    python -m multiverso_tpu_torch.tools.check_obs_surface   # exit 0 clean, 1 findings

Run by ``tests/test_torch_cluster_obs.py`` in tier-1.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, List

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)
_PKG = "multiverso_tpu_torch"
# the heading of README.md's section on the port: lint 2 reads it
_README_PORT_HEADING = "## PyTorch/CUDA port (`multiverso_tpu_torch`)"

# trailing comments allowed: this codebase styles constants as
# "MSG_X = 0x1E  # what it is", and a commented definition escaping the
# scan would re-open the exact crack this tool closes
_MSG_RE = re.compile(
    r"^(MSG_[A-Z_0-9]+)\s*=\s*(?:0x[0-9a-fA-F]+|\d+)\s*(?:#.*)?$", re.M)
_FLAG_RE = re.compile(
    r"""define_(?:bool|int|float|string)\(\s*['"]([^'"]+)['"]""")


def wire_opcodes() -> List[str]:
    """MSG_* names defined in the wire/service layer (source scan — the
    lint must see an opcode the moment it is committed, imported
    anywhere or not)."""
    names: List[str] = []
    for rel in (f"{_PKG}/ps/service.py", f"{_PKG}/ps/wire.py"):
        with open(os.path.join(_REPO, rel)) as f:
            names += _MSG_RE.findall(f.read())
    return sorted(set(names))


def defined_flags() -> List[str]:
    """Every config.define_* flag name under multiverso_tpu_torch/."""
    names: List[str] = []
    for root, _dirs, files in os.walk(os.path.join(_REPO, _PKG)):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(root, fn)) as f:
                names += _FLAG_RE.findall(f.read())
    return sorted(set(names))


# ---------------------------------------------------------------------- #
# stats-surface rule (lint 3): emitted keys vs the rendering tools
# ---------------------------------------------------------------------- #
# (file, function) pairs whose emitted top-level keys ARE the stats
# surface — jax-free ast scans, so the lint runs on a bare host
_STATS_SOURCES = (
    (f"{_PKG}/ps/shard.py", "stats"),
    (f"{_PKG}/ps/service.py", "stats_payload"),
    (f"{_PKG}/telemetry/exporter.py", "default_stats_fn"),
    (f"{_PKG}/telemetry/memstats.py", "stats_snapshot"),
)
_RENDERERS = (f"{_PKG}/tools/mvtop.py", f"{_PKG}/tools/dump_metrics.py")

# intentionally raw keys: shard-stat SCALARS whose only rendering is
# dump_metrics' generic "k=v" shard join (format_record prints every
# shard key, so a first-class column would add nothing), plus process
# identity plumbing. New BLOCK keys (serving/profile/memory-style)
# never belong here — blocks are structured, not generically joined,
# and an unrendered block is exactly what this lint exists to catch.
_STATS_RAW_KEYS = frozenset({
    "kind", "lo", "rows", "cols", "bytes", "version", "wave_ops",
    "wave_max_ops", "get_chunks", "cow_applies", "read_pins",
    "dup_frames", "replay_clients", "snapshots", "snapshots_unchanged",
    "dirty_rows", "keys", "pending_bytes",
    "native_applies",   # the C++ server's applies folded into a shard
    "pid",   # the aggregator's (host, pid) process-dedupe token
})


def stats_keys(rel_path: str, func: str,
               repo: str = _REPO) -> List[str]:
    """Top-level string keys emitted by every function named ``func``
    in ``rel_path``: dict-literal keys, ``.update(k=...)`` keyword
    args, ``.setdefault("k", ...)``, and ``x["k"] = ...`` subscript
    assigns. Over-approximates (nested literals count too) — a spare
    entry costs one allowlist line, a missed one costs a dark key."""
    with open(os.path.join(repo, rel_path)) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if not (isinstance(node, (ast.FunctionDef,
                                  ast.AsyncFunctionDef))
                and node.name == func):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Dict):
                for k in sub.keys:
                    if (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)):
                        keys.add(k.value)
            elif isinstance(sub, ast.Call):
                fn = sub.func
                if isinstance(fn, ast.Attribute) \
                        and fn.attr in ("update", "setdefault"):
                    for kw in sub.keywords:
                        if kw.arg:
                            keys.add(kw.arg)
                    if (fn.attr == "setdefault" and sub.args
                            and isinstance(sub.args[0], ast.Constant)
                            and isinstance(sub.args[0].value, str)):
                        keys.add(sub.args[0].value)
            elif isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if (isinstance(tgt, ast.Subscript)
                            and isinstance(tgt.slice, ast.Constant)
                            and isinstance(tgt.slice.value, str)):
                        keys.add(tgt.slice.value)
    return sorted(keys)


def stats_surface_findings(
        keys_by_src: Dict[str, List[str]] = None,
        renderer_text: str = None,
        allow: frozenset = _STATS_RAW_KEYS) -> List[str]:
    """Lint 3 proper: every emitted key must appear quoted in a
    renderer's source or on the allowlist. Parameters are injectable
    so tests can prove the rule CATCHES a fabricated dark key."""
    if keys_by_src is None:
        keys_by_src = {f"{path}:{func}()": stats_keys(path, func)
                       for path, func in _STATS_SOURCES}
    if renderer_text is None:
        renderer_text = ""
        for rel in _RENDERERS:
            with open(os.path.join(_REPO, rel)) as f:
                renderer_text += f.read()
    findings = []
    for src, keys in sorted(keys_by_src.items()):
        for key in keys:
            if key in allow:
                continue
            if f'"{key}"' in renderer_text or f"'{key}'" in renderer_text:
                continue
            findings.append(
                f"stats key {key!r} (emitted by {src}): rendered by "
                "neither the port's tools/mvtop.py nor tools/dump_metrics.py — "
                "add a panel/row (or an explicit raw-key allowlist "
                "entry) so the block cannot go dark")
    return findings


# ---------------------------------------------------------------------- #
# collective-coverage rule (lint 4): device-plane ops must record
# ---------------------------------------------------------------------- #
# (file, mode): "all" = every public top-level function is a collective
# entry point and must record; "shard_map" = only public functions that
# dispatch through the mesh (call _shard_map/shard_map) must. The port's
# collectives.py and tp.py join this table with the mesh slice.
_COLLECTIVE_SOURCES = (
    (f"{_PKG}/parallel/ring.py", "shard_map"),
)
# a function "records" when its body calls one of these devstats sites
_RECORDING_CALLS = frozenset({"collective_span", "note_transfer"})


def _called_names(node: ast.AST) -> set:
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            if isinstance(fn, ast.Attribute):
                out.add(fn.attr)
            elif isinstance(fn, ast.Name):
                out.add(fn.id)
    return out


def collective_coverage_findings(
        sources=_COLLECTIVE_SOURCES,
        source_text: Dict[str, str] = None) -> List[str]:
    """Lint 4: every collective entry point in ``parallel/`` must wrap
    its dispatch in ``devstats.collective_span`` (or count through
    ``note_transfer``) — the exact MSG_SNAPSHOT crack for the device
    plane: a new collective op shipping with no span is invisible to
    mvtop/flightrec/the scale harness. ``source_text`` injects
    {rel_path: source} so tests can prove the rule catches a dark op."""
    findings = []
    for rel, mode in sources:
        if source_text is not None and rel in source_text:
            src = source_text[rel]
        else:
            with open(os.path.join(_REPO, rel)) as f:
                src = f.read()
        for node in ast.parse(src).body:
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                    or node.name.startswith("_"):
                continue
            calls = _called_names(node)
            if mode == "shard_map" \
                    and not calls & {"_shard_map", "shard_map"}:
                continue   # host-side helper, not a mesh dispatch
            if not calls & _RECORDING_CALLS:
                findings.append(
                    f"collective {rel}:{node.name}(): dispatches on the "
                    "mesh with no devstats recording site — wrap the "
                    "dispatch in devstats.collective_span (or count it "
                    "via note_transfer) so the op cannot ship dark")
    return findings


# ---------------------------------------------------------------------- #
# tenant-surface rule (lint 6): the MSG_STATS "tenants" block renders
# ---------------------------------------------------------------------- #
# (file, function) pairs whose emitted keys ARE the tenant block: the
# ledger's stats_snapshot (block structure + per-(table, tenant)
# counters), the shard meter's counter shape (note builds the entry
# dicts, to_dict adds the sketch key), and the admission controller's
# per-tenant budget entries that ride the block's "admission" map.
_TENANT_SOURCES = (
    (f"{_PKG}/telemetry/tenants.py", "stats_snapshot"),
    (f"{_PKG}/telemetry/tenants.py", "note"),
    (f"{_PKG}/telemetry/tenants.py", "to_dict"),
    (f"{_PKG}/serving/admission.py", "tenant_stats"),
)


def tenant_surface_findings(keys_by_src: Dict[str, List[str]] = None,
                            renderer_text: str = None) -> List[str]:
    """Lint 6: every key the tenants block emits must appear quoted in
    ``tools/mvtop.py`` or ``tools/dump_metrics.py`` — the lint-3 rule
    applied to the tenant plane with NO allowlist: per-tenant evidence
    that no pane of glass shows is exactly how a noisy-neighbor episode
    goes dark. Injectable so tests can prove the rule catches a
    fabricated dark key."""
    if keys_by_src is None:
        keys_by_src = {f"{path}:{func}()": stats_keys(path, func)
                       for path, func in _TENANT_SOURCES}
    if renderer_text is None:
        renderer_text = ""
        for rel in _RENDERERS:
            with open(os.path.join(_REPO, rel)) as f:
                renderer_text += f.read()
    findings = []
    for src, keys in sorted(keys_by_src.items()):
        for key in keys:
            if f'"{key}"' in renderer_text or f"'{key}'" in renderer_text:
                continue
            findings.append(
                f"tenant stats key {key!r} (emitted by {src}): rendered "
                "by neither the port's tools/mvtop.py nor tools/dump_metrics.py — "
                "add it to the tenant panel/table so per-tenant "
                "evidence cannot go dark")
    return findings


# ---------------------------------------------------------------------- #
# slo-surface rule (lint 7): every objective kind and bus signal renders
# ---------------------------------------------------------------------- #
# module-level string-tuple registries that ARE the SLO surface: the
# sentinel's objective kinds and the signal bus's published names. Read
# by ast (no import — slo.py pulls in the config plane, and this lint
# must run on a bare host).
_SLO_REGISTRIES = (
    (f"{_PKG}/telemetry/slo.py", "OBJECTIVE_KINDS",
     "SLO objective kind"),
    (f"{_PKG}/telemetry/signals.py", "SIGNAL_NAMES",
     "signal-bus name"),
)


def module_tuple(rel_path: str, name: str,
                 repo: str = _REPO) -> List[str]:
    """The strings of a module-level ``NAME = ("a", "b", ...)`` tuple
    assignment, read by ast so the lint sees the registry the moment
    it is committed, importable or not."""
    with open(os.path.join(repo, rel_path)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if any(isinstance(t, ast.Name) and t.id == name
               for t in node.targets):
            return [str(v) for v in ast.literal_eval(node.value)]
    return []


def slo_surface_findings(kinds: List[str] = None,
                         signal_names: List[str] = None,
                         renderer_text: str = None) -> List[str]:
    """Lint 7: every objective kind ``telemetry/slo.py`` can judge and
    every signal name ``telemetry/signals.py`` can publish must appear
    quoted in ``tools/mvtop.py`` or ``tools/dump_metrics.py`` — the
    lint-3 rule applied to the SLO plane with NO allowlist: an
    objective kind no pane can show is a verdict into the void, and a
    bus signal nothing renders is an autoscaling input no operator can
    audit. Injectable so tests can prove the rule catches a fabricated
    dark kind."""
    if kinds is None:
        kinds = module_tuple(*_SLO_REGISTRIES[0][:2])
    if signal_names is None:
        signal_names = module_tuple(*_SLO_REGISTRIES[1][:2])
    if renderer_text is None:
        renderer_text = ""
        for rel in _RENDERERS:
            with open(os.path.join(_REPO, rel)) as f:
                renderer_text += f.read()
    findings = []
    for label, (rel, _reg, what) in (("kind", _SLO_REGISTRIES[0]),
                                     ("signal", _SLO_REGISTRIES[1])):
        names = kinds if label == "kind" else signal_names
        for key in names:
            if f'"{key}"' in renderer_text or f"'{key}'" in renderer_text:
                continue
            findings.append(
                f"{what} {key!r} (declared in {rel}): rendered by "
                "neither the port's tools/mvtop.py nor tools/dump_metrics.py — "
                "add it to the SLO panel / _slo_lines table so the "
                "sentinel's verdicts cannot go dark")
    return findings


def flag_docs_text(repo: str = _REPO) -> str:
    """docs/TUNING.md (the knobs the port shares with the JAX package,
    read and never edited from here) plus README.md's port section, up
    to the next top-level heading."""
    with open(os.path.join(repo, "docs", "TUNING.md")) as f:
        text = f.read()
    with open(os.path.join(repo, "README.md")) as f:
        readme = f.read()
    i = readme.find(_README_PORT_HEADING)
    if i >= 0:
        j = readme.find("\n## ", i + len(_README_PORT_HEADING))
        text += readme[i:j if j >= 0 else len(readme)]
    return text


def check() -> List[str]:
    """All findings as human-readable strings ([] = clean)."""
    findings: List[str] = []
    from multiverso_tpu_torch.telemetry import flightrec

    cov = flightrec.MSG_EV_COVERAGE
    for op in wire_opcodes():
        if op not in cov:
            findings.append(
                f"{op}: no flightrec.MSG_EV_COVERAGE entry — name the "
                "ring events marking its lifecycle (or an explicit () "
                "with the probe-exclusion reason)")
            continue
        for ev in cov[op]:
            if ev not in flightrec.EV_NAMES:
                findings.append(
                    f"{op}: coverage names unknown event id {ev!r} "
                    "(not in flightrec.EV_NAMES)")
    stale = sorted(set(cov) - set(wire_opcodes()))
    for op in stale:
        findings.append(
            f"{op}: MSG_EV_COVERAGE entry for an opcode that no longer "
            "exists in ps/service.py or ps/wire.py")

    docs = flag_docs_text()
    for flag in defined_flags():
        # a flag is "documented" when its name appears anywhere in
        # TUNING.md or the README's port section
        if flag not in docs:
            findings.append(
                f"flag {flag!r}: mentioned in neither docs/TUNING.md nor "
                "README.md's port section — add a row to the port's "
                "flag table")
    findings.extend(stats_surface_findings())
    findings.extend(collective_coverage_findings())
    findings.extend(tenant_surface_findings())
    findings.extend(slo_surface_findings())
    return findings


def main(argv=None) -> int:
    findings = check()
    for f in findings:
        print(f"OBS-SURFACE: {f}")
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    nkeys = sum(len(stats_keys(p, fn)) for p, fn in _STATS_SOURCES)
    print(f"observability surface clean: "
          f"{len(wire_opcodes())} opcodes covered, "
          f"{len(defined_flags())} flags documented, "
          f"{nkeys} stats keys rendered/allowlisted")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
