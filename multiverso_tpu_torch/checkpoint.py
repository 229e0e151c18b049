"""Checkpoint / resume of the full table state (port of
``multiverso_tpu/checkpoint.py``, its ``stream`` format).

``save``/``restore`` walk the Zoo's table registry and serialize every
table's data *and updater state* through the URI-dispatched stream layer
(``io/stream.open_stream``): one stream per table
(``<name>.<table_id>.mvt``) holding the table's own ``store()`` payload,
a ``manifest.json`` with names, shapes and dtypes, and a commit marker
written LAST. The tables' payloads are the JAX package's, so a checkpoint
written by either package restores in the other.

The per-shard half (``save_shard_state`` and friends) snapshots ONE
rank's locally owned async shards (data, updater state, replay sequence
channels, apply version) for shard failover (``ps/failover.py``): a
restarted incarnation restores exactly its own rows without touching its
peers' newer live state. Its files are the JAX package's too (an
``np.save`` JSON header, then the arrays).

Not ported (ROADMAP.md §A): ``backend="orbax"`` and ``block=False`` (a
JAX library's sharded, asynchronous format) raise ``ValueError``; the
memory ledger's checkpoint gauges are telemetry.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np

from multiverso_tpu_torch.io.stream import open_stream
from multiverso_tpu_torch.utils import log
from multiverso_tpu_torch.zoo import Zoo

# Commit marker written LAST into every checkpoint directory: a tag whose
# manifest exists but whose marker does not is a torn write (the writer
# died mid-checkpoint), invisible to latest() and rejected by restore().
COMMIT_MARKER = "COMMIT"


def _join(base: str, *parts: str) -> str:
    """Path join that keeps URI schemes (os.path.join would mangle
    gs://bucket into a local-looking path)."""
    if "://" in base:
        return "/".join([base.rstrip("/"), *parts])
    return os.path.join(base, *parts)


def is_local(path: str) -> bool:
    return "://" not in path or path.startswith("file://")


def _write_commit(path: str) -> None:
    with open_stream(_join(path, COMMIT_MARKER), "wb") as s:
        s.write(b"1")


def is_committed(path: str) -> bool:
    """True when ``path`` holds a COMPLETE checkpoint (the commit marker
    was written after everything else)."""
    if is_local(path):
        local = path[len("file://"):] if path.startswith("file://") else path
        return os.path.exists(os.path.join(local, COMMIT_MARKER))
    try:
        with open_stream(_join(path, COMMIT_MARKER), "rb") as s:
            s.read(1)
        return True
    except Exception:   # noqa: BLE001 — a missing remote marker
        return False


def _check_backend(backend: str, block: bool) -> None:
    if backend == "orbax" or not block:
        raise ValueError(
            f"checkpoint backend={backend!r}, block={block}: the orbax "
            "format and its asynchronous save are a JAX library's and are "
            "not ported to multiverso_tpu_torch (ROADMAP.md §A \"The "
            "rest\"); use backend='stream', block=True")
    if backend != "stream":
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def _manifest_entry(table) -> Dict:
    entry = {"name": table.name, "type": type(table).__name__}
    if hasattr(table, "shape"):
        entry["shape"] = list(table.shape)
        # the numpy dtype's name, as the JAX package writes it
        entry["dtype"] = str(getattr(table, "np_dtype", table.dtype))
    return entry


def save(directory: str, tag: str = "checkpoint",
         backend: str = "stream", block: bool = True) -> str:
    """Write every registered table (data + updater state) under
    ``directory/tag/``; the commit marker lands last. Returns the
    checkpoint path. The process is rank 0 of a world of one, which
    writes everything (the JAX package's other ranks write nothing)."""
    _check_backend(backend, block)
    zoo = Zoo.get()
    path = _join(directory, tag)
    manifest: Dict = {"tables": {}, "version": 1}
    for table_id, table in zoo.tables().items():
        if not hasattr(table, "store"):
            continue
        fname = f"{table.name}.{table_id}.mvt"
        with open_stream(_join(path, fname), "wb") as s:
            table.store(s)
        manifest["tables"][str(table_id)] = dict(
            _manifest_entry(table), file=fname)
    with open_stream(_join(path, "manifest.json"), "wb") as s:
        s.write(json.dumps(manifest, indent=2).encode())
    _write_commit(path)
    log.info("checkpoint saved: %s (%d tables)", path,
             len(manifest["tables"]))
    zoo.barrier()
    return path


def restore(directory: str, tag: str = "checkpoint") -> int:
    """Load every registered table from a checkpoint written by
    :func:`save` (of either package). Tables are matched by registration
    id and name; mismatched shapes raise. Returns the number of tables
    restored."""
    zoo = Zoo.get()
    path = _join(directory, tag)
    if not is_committed(path):
        raise ValueError(
            f"checkpoint {path} has no commit marker — the save was "
            "torn/partial (writer died mid-checkpoint); restore the "
            "previous committed tag instead")
    with open_stream(_join(path, "manifest.json"), "rb") as s:
        manifest = json.loads(s.read().decode())
    if manifest.get("backend", "stream") != "stream":
        _check_backend(manifest["backend"], True)
    restored = 0
    for table_id, table in zoo.tables().items():
        entry = manifest["tables"].get(str(table_id))
        if entry is None or not hasattr(table, "load"):
            continue
        if entry["name"] != table.name:
            raise ValueError(
                f"checkpoint table {table_id} is {entry['name']!r}, "
                f"registry has {table.name!r} — create tables in the same "
                "order before restoring")
        with open_stream(_join(path, entry["file"]), "rb") as s:
            table.load(s)
        restored += 1
    zoo.barrier()
    log.info("checkpoint restored: %s (%d tables)", path, restored)
    return restored


def latest(directory: str) -> Optional[str]:
    """Most recent COMMITTED tag under ``directory`` (by manifest mtime).
    Tags without the commit marker — torn saves — are invisible. Local
    filesystems only (remote URIs return None)."""
    if not is_local(directory) or not os.path.isdir(directory):
        return None
    best, best_mtime = None, -1.0
    skipped = []
    for tag in os.listdir(directory):
        base = os.path.join(directory, tag)
        m = os.path.join(base, "manifest.json")
        if not os.path.exists(m):
            continue
        if not os.path.exists(os.path.join(base, COMMIT_MARKER)):
            skipped.append(tag)
            continue
        mt = os.path.getmtime(m)
        if mt > best_mtime:
            best, best_mtime = tag, mt
    if skipped:
        # loud: a tag with a manifest but no marker is a torn save (the
        # skip is the fix) or a checkpoint from before the marker (which
        # needs a manual COMMIT file); cold-starting over saved state
        # silently would be the worst outcome
        log.error("checkpoint latest(%s): skipping %d uncommitted tag(s) "
                  "%s — torn saves, or checkpoints from before the commit "
                  "marker needing a manual COMMIT file", directory,
                  len(skipped), sorted(skipped)[:4])
    return best


# ---------------------------------------------------------------------- #
# per-shard incremental checkpoints (shard failover, ps/failover.py):
# ONE rank's locally owned shards, local filesystems only
# ---------------------------------------------------------------------- #
def _shard_base(directory: str, rank: int) -> str:
    return os.path.join(directory, f"shard-r{int(rank)}")


def _checkpointable_shards(tables):
    """(name, shard) pairs of the local shards with the failover
    checkpoint surface. Accepts a list of async tables, a ``{name:
    shard}`` dict (the PSService registry shape), or a zero-arg callable
    returning either."""
    if callable(tables):
        tables = tables()
    if isinstance(tables, dict):
        return [(n, s) for n, s in tables.items()
                if hasattr(s, "checkpoint_state")]
    out = []
    for t in tables:
        shard = getattr(t, "_shard", None)
        if shard is None and hasattr(t, "_m"):   # AsyncArrayTable wraps
            shard = getattr(t._m, "_shard", None)
        if shard is not None and hasattr(shard, "checkpoint_state"):
            out.append((t.name, shard))
    return out


def _save_shard_file(path: str, meta: Dict, arrays) -> None:
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        np.save(f, np.frombuffer(header, np.uint8), allow_pickle=False)
        np.save(f, np.array([len(arrays)], np.int64), allow_pickle=False)
        for a in arrays:
            # a 0-d leaf (Adam's step) stays 0-d: np.ascontiguousarray
            # would make it (1,), which the JAX package's restore rejects
            # (ROADMAP C.14)
            np.save(f, np.ascontiguousarray(a) if np.ndim(a) else
                    np.asarray(a), allow_pickle=False)


def _load_shard_file(path: str):
    with open(path, "rb") as f:
        meta = json.loads(np.load(f).tobytes().decode())
        n = int(np.load(f)[0])
        arrays = [np.load(f) for _ in range(n)]
    return meta, arrays


def save_shard_state(directory: str, rank: int, tables) -> str:
    """Write one COMMITTED snapshot of ``rank``'s local shards under
    ``directory/shard-r<rank>/v<N>/`` (a monotonic tag; the commit marker
    lands last, so a writer dying mid-save leaves an invisible torn tag).
    After the commit, each shard's durable replay floors advance
    (``mark_durable``): from then on its stamped acks tell clients the
    snapshot's sequences survive a crash. Returns the tag path."""
    if not is_local(directory):
        raise ValueError("per-shard failover checkpoints require a "
                         f"local/NFS directory, got {directory!r}")
    base = _shard_base(directory, rank)
    os.makedirs(base, exist_ok=True)
    nxt = 0
    for name in os.listdir(base):
        if name.startswith("v") and name[1:].isdigit():
            nxt = max(nxt, int(name[1:]) + 1)
    path = os.path.join(base, f"v{nxt:09d}")
    os.makedirs(path, exist_ok=True)
    manifest: Dict = {"version": 1, "rank": int(rank), "tables": {}}
    shards = _checkpointable_shards(tables)
    metas = []
    for name, shard in shards:
        meta, arrays = shard.checkpoint_state()
        fname = f"{name}.mvs"
        _save_shard_file(os.path.join(path, fname), meta, arrays)
        manifest["tables"][name] = {"file": fname,
                                    "kind": meta.get("kind"),
                                    "version": meta.get("version")}
        metas.append((shard, meta))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    _write_commit(path)
    # durable ONLY now: the marks must never run ahead of a commit a
    # replacement could actually restore
    for shard, meta in metas:
        shard.mark_durable({cl: int(chan.get("floor", -1))
                            for cl, chan in
                            (meta.get("replay") or {}).items()})
    log.debug("shard checkpoint saved: %s (%d shards)", path, len(shards))
    return path


def latest_shard_tag(directory: str, rank: int) -> Optional[str]:
    """Newest COMMITTED per-shard tag for ``rank`` (torn tags skipped), or
    None when the rank never completed a save."""
    base = _shard_base(directory, rank)
    if not os.path.isdir(base):
        return None
    tags = sorted((n for n in os.listdir(base)
                   if n.startswith("v") and n[1:].isdigit()
                   and os.path.exists(os.path.join(base, n,
                                                   COMMIT_MARKER))),
                  reverse=True)
    return tags[0] if tags else None


def restore_shard_state(directory: str, rank: int, tables,
                        tag: Optional[str] = None) -> int:
    """Restore ``rank``'s local shards from its newest committed per-shard
    checkpoint (or an explicit ``tag``), onto each shard's own device.
    Tables absent from the snapshot keep their fresh state; snapshot
    entries without a live table are skipped. Returns the number of
    shards restored (0 when no committed tag exists — a cold start)."""
    tag = tag or latest_shard_tag(directory, rank)
    if tag is None:
        return 0
    path = os.path.join(_shard_base(directory, rank), tag)
    if not is_committed(path):
        raise ValueError(f"shard checkpoint {path} is not committed")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = dict(_checkpointable_shards(tables))
    restored = 0
    for name, entry in manifest.get("tables", {}).items():
        shard = by_name.get(name)
        if shard is None:
            continue
        meta, arrays = _load_shard_file(os.path.join(path, entry["file"]))
        shard.restore_checkpoint(meta, arrays)
        restored += 1
    log.info("shard checkpoint restored: %s (%d shards)", path, restored)
    return restored


def prune_shard_tags(directory: str, rank: int, keep: int = 2) -> None:
    """Drop all but the newest ``keep`` committed per-shard tags, plus any
    torn (uncommitted) tag older than the newest committed one."""
    base = _shard_base(directory, rank)
    if not os.path.isdir(base):
        return
    tags = sorted(n for n in os.listdir(base)
                  if n.startswith("v") and n[1:].isdigit())
    committed = [n for n in tags
                 if os.path.exists(os.path.join(base, n, COMMIT_MARKER))]
    drop = set(committed[: -max(keep, 1)])
    if committed:
        newest = committed[-1]
        drop.update(n for n in tags
                    if n < newest and n not in committed)
    for n in drop:
        shutil.rmtree(os.path.join(base, n), ignore_errors=True)
