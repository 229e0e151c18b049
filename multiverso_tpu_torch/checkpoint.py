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

``save(..., block=False)`` returns once every table's state is
snapshotted (device state into pinned host buffers, ordered before any
later op of the table; host state copied) and writes the same files on a
thread. The checkpoint becomes visible (manifest, then the commit marker,
so ``latest()`` sees it) only in :func:`wait_pending`, which the next
save or restore calls itself: at most one such save is in flight. A
failed background write is discarded, never made visible, and raised.

The memory ledger (``telemetry/memstats.py``) carries the checkpoint
plane's gauges under ``checkpoint``: host bytes staged by in-progress
saves (a snapshot's buffers until its files are written, a per-shard
save's copies) and the on-disk size of each rank's last committed tag.

``save(..., backend="orbax")`` is the sharded checkpoint, under the JAX
package's backend name, so that a caller's code and
``ElasticLoop(backend="orbax")`` run unchanged; its files are the port's
own, not orbax's (orbax is a JAX library). Each rank writes only its own
block of every table's data and row-shaped updater state, with
``np.save``, under ``<tag>/arrays/table_<id>/`` (``data.<k>.npy``,
``ustate.<key>.<k>.npy`` for block ``k``); rank 0 writes the leaves shared
by all rows (``ustate.<key>.npy``), a JSON index a table
(``index.json``: :meth:`Table.block_index`) and the tables without a
device state (KV, async) in the stream format, as the JAX package does.
Nothing is gathered. The ranks then vote, and rank 0 writes the manifest
(``"backend": "orbax"``, ``"layout"``: :data:`LAYOUT`) and the commit
marker only if every rank's files are whole; a failure on any rank
raises on every rank and nothing becomes visible. ``block=False``
snapshots each rank's block into pinned host buffers and writes on a
thread; the vote and the manifest wait for :func:`wait_pending`. A
restore reads, on each rank, only the saved rows that overlap its block
(memory-mapped where local), so a checkpoint saved at any world size
restores at any other. Neither package reads the other's sharded tags: a
JAX-written orbax tag (no ``"layout"``) raises ``ValueError`` here, and
the JAX restore fails inside orbax on the port's (ROADMAP C.27); the
stream format crosses both ways.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np

from multiverso_tpu_torch.io.stream import open_stream
from multiverso_tpu_torch.telemetry import memstats as _memstats
from multiverso_tpu_torch.utils import log
from multiverso_tpu_torch.zoo import Zoo


class _CheckpointGauges:
    """Byte-ledger gauges for the checkpoint plane: host bytes STAGED by
    in-progress saves (owned copies of shard data and updater-state
    leaves, nonzero only while a save runs) and the on-disk size of the
    last committed tag per rank base. One process-global instance, but
    not one save at a time: an in-process multi-rank world runs one
    checkpointer thread per rank, so staging accumulates (stage/unstage
    deltas under a lock) and committed-tag sizes key by base directory."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._staging = 0
        self._tags: Dict[str, int] = {}

    def stage(self, nbytes: int) -> None:
        with self._lock:
            self._staging += int(nbytes)

    def unstage(self, nbytes: int) -> None:
        with self._lock:
            self._staging -= int(nbytes)

    def note_tag(self, base: str, nbytes: int) -> None:
        with self._lock:
            self._tags[base] = int(nbytes)

    def memory_stats(self) -> Dict[str, int]:
        with self._lock:
            return {"staging_bytes": max(int(self._staging), 0),
                    "disk_tag_bytes": int(sum(self._tags.values()))}


_GAUGES = _CheckpointGauges()
_memstats.register("checkpoint", _GAUGES)


def _dir_bytes(path: str) -> int:
    """Total file bytes under ``path`` (a missing tree reads as 0: the
    gauge must never fail a save)."""
    total = 0
    try:
        for root, _dirs, files in os.walk(path):
            for fn in files:
                try:
                    total += os.path.getsize(os.path.join(root, fn))
                except OSError:
                    pass
    except OSError:
        pass
    return total

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


def _local(path: str) -> str:
    """A local path or ``file://`` URI as a filesystem path."""
    return path[len("file://"):] if path.startswith("file://") else path


def _write_commit(path: str) -> None:
    with open_stream(_join(path, COMMIT_MARKER), "wb") as s:
        s.write(b"1")


def is_committed(path: str) -> bool:
    """True when ``path`` holds a COMPLETE checkpoint (the commit marker
    was written after everything else)."""
    if is_local(path):
        return os.path.exists(os.path.join(_local(path), COMMIT_MARKER))
    try:
        with open_stream(_join(path, COMMIT_MARKER), "rb") as s:
            s.read(1)
        return True
    except Exception:   # noqa: BLE001 — a missing remote marker
        return False


BACKENDS = ("stream", "orbax")
# names the port's per-rank layout of backend="orbax" in the manifest: a
# tag without it is orbax's own format, written by the JAX package
LAYOUT = "multiverso_tpu_torch/rank-blocks/1"


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}; choose "
                         f"from {BACKENDS}")


def _manifest_entry(table) -> Dict:
    entry = {"name": table.name, "type": type(table).__name__}
    if hasattr(table, "shape"):
        entry["shape"] = list(table.shape)
        # the numpy dtype's name, as the JAX package writes it
        entry["dtype"] = str(getattr(table, "np_dtype", table.dtype))
    return entry


def _snapshot(table):
    """``(write, nbytes)`` of a table's state now: the table's own
    ``store_snapshot`` where it has one (device state into pinned host
    buffers), else its ``store`` payload copied into host memory now."""
    snap = getattr(table, "store_snapshot", None)
    if callable(snap):
        return snap()
    buf = io.BytesIO()
    table.store(buf)
    data = buf.getvalue()
    return (lambda stream: stream.write(data)), len(data)


class _DevNull:
    """A discarding sink: a rank other than 0 still runs a sharded
    table's ``store`` (its gather is a collective), and nothing is
    written."""

    def write(self, b):
        return len(b)


class _SaveJob:
    """One save's files, written by a thread (``block=False``) or inline:
    ``jobs`` of ``(name under path, write(stream), nbytes)``, this rank's
    own. It becomes visible only through :func:`_commit`, which every
    rank calls: the ranks vote on their files, and rank 0 (``writer``)
    writes the manifest only if every rank's are whole. ``staged`` is
    the host memory the jobs hold until they are written."""

    def __init__(self, path: str, manifest: Dict, jobs,
                 writer: bool = True) -> None:
        self.path, self.manifest = path, manifest
        self.writer = writer
        self.error: Optional[Exception] = None
        self._written = False   # every file, to its end
        self._jobs = jobs
        self._thread: Optional[threading.Thread] = None
        self.staged = sum(n for _, _, n in jobs)
        _GAUGES.stage(self.staged)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run,
                                        name="mv-checkpoint-save",
                                        daemon=True)
        self._thread.start()

    def run(self) -> None:
        jobs, self._jobs = self._jobs, []
        try:
            for fname, write, _ in jobs:
                with open_stream(_join(self.path, fname), "wb") as s:
                    write(s)
            self._written = True
        except Exception as e:   # noqa: BLE001 — raised by finish()
            self.error = e
        finally:
            jobs.clear()   # the snapshots' buffers go now
            _GAUGES.unstage(self.staged)

    def finish(self) -> None:
        """Wait for the files, then vote (a collective): raise on every
        rank unless every rank's files are whole, this rank's own error
        where its write failed."""
        if self._thread is not None:
            self._thread.join()
        if self.error is None and not self._written:
            self.error = RuntimeError(f"checkpoint {self.path}: the write "
                                      "ended before its last file")
        failed = _failed_ranks(self.error is None)
        if self.error is not None:
            raise self.error
        if failed:
            raise RuntimeError(f"checkpoint {self.path}: rank(s) {failed} "
                               "failed to write their files")


def _failed_ranks(ok: bool) -> list:
    """The ranks whose ``ok`` is False: an all-gather of one flag a rank
    over the world (a collective); ``[]`` or ``[0]`` in one process."""
    from multiverso_tpu_torch.parallel.collectives import process_allgather
    flags = process_allgather(np.array([int(bool(ok))], np.int32))
    return [r for r, f in enumerate(flags.reshape(-1)) if not f]


_pending: Optional[_SaveJob] = None   # the save awaiting its manifest
_pending_lock = threading.Lock()


def _write_manifest(path: str, manifest: Dict) -> None:
    with open_stream(_join(path, "manifest.json"), "wb") as s:
        s.write(json.dumps(manifest, indent=2).encode())
    _write_commit(path)


def _commit(job: _SaveJob) -> None:
    """Finish ``job`` (its vote), then have rank 0 write its manifest and
    commit marker, and meet every rank at the barrier. A failed write on
    any rank is discarded on every rank (no manifest, no marker:
    ``latest`` keeps the previous committed tag) and raised on every
    rank."""
    try:
        job.finish()
    except BaseException:
        log.error("checkpoint write failed; discarded the unfinalized "
                  "checkpoint %s", job.path)
        raise
    if job.writer:
        _write_manifest(job.path, job.manifest)
        log.info("checkpoint finalized: %s (%d tables)", job.path,
                 len(job.manifest["tables"]))
    Zoo.get().barrier()


def wait_pending() -> int:
    """Finish the in-flight ``block=False`` save, if any: wait for its
    files, vote, then write its manifest and commit marker (it becomes
    visible to ``restore`` and ``latest``) and meet every rank at the
    barrier. Returns the number finalized (0 or 1). A failed background
    write on any rank is discarded and raised on every rank."""
    global _pending
    with _pending_lock:
        job, _pending = _pending, None
    if job is None:
        return 0
    _commit(job)
    return 1


def _array_writer(host, done):
    """A job's ``write``: ``host`` (a snapshot's tensor) with ``np.save``
    once the copy's event ``done`` has fired."""
    def write(stream) -> None:
        if done is not None:
            done.synchronize()
        np.save(stream, host.numpy(), allow_pickle=False)
    return write


def _sharded_jobs(zoo, writer: bool):
    """The manifest of a sharded save and this rank's jobs, every table's
    state snapshotted now: this rank's block files of each table with a
    device state; on rank 0 (``writer``) also the leaves shared by all
    rows, each table's index, and the other tables' stream files. No
    collective."""
    manifest: Dict = {"version": 1, "backend": "orbax", "layout": LAYOUT,
                      "tables": {}}
    jobs = []
    for table_id, table in zoo.tables().items():
        if hasattr(table, "block_snapshot"):
            manifest["tables"][str(table_id)] = dict(
                _manifest_entry(table), kind="orbax")
            tdir = f"arrays/table_{table_id}"
            files, done = table.block_snapshot(shared=writer)
            for name, host in files:
                jobs.append((f"{tdir}/{name}", _array_writer(host, done),
                             host.numel() * host.element_size()))
            if writer:
                index = json.dumps(dict(table.block_index(),
                                        name=table.name)).encode()
                jobs.append((f"{tdir}/index.json",
                             lambda s, b=index: s.write(b), len(index)))
        elif hasattr(table, "store"):
            # tables without a device state ride the stream format in the
            # same tag, written by rank 0, as the JAX package does
            fname = f"{table.name}.{table_id}.mvt"
            manifest["tables"][str(table_id)] = dict(
                _manifest_entry(table), kind="stream", file=fname)
            if writer:
                jobs.append((fname, *_snapshot(table)))
    return manifest, jobs


def save(directory: str, tag: str = "checkpoint",
         backend: str = "stream", block: bool = True) -> str:
    """Write every registered table (data + updater state) under
    ``directory/tag/``; the commit marker lands last. Returns the
    checkpoint path. A collective in a world of several processes, as in
    the JAX package (every rank passes the same ``directory``, which
    every rank's ``restore`` reads); the ranks meet at the barrier.

    ``backend="stream"``: rank 0 writes the whole of each table, and the
    other ranks take part in the gathers of the sharded tables' blocks.
    An async PS table's ``store`` is no collective: the other ranks skip
    it. ``backend="orbax"``: each rank writes its own blocks (the module
    docstring), and nothing is gathered.

    ``block=False`` returns once every table's state is snapshotted (with
    the stream format a sharded table's blocks are gathered now) and
    writes the files on a thread; the vote, the manifest and the marker
    wait for :func:`wait_pending` (the next save or restore calls it).
    Each save first finalizes the one in flight."""
    _check_backend(backend)
    wait_pending()
    zoo = Zoo.get()
    writer = zoo.rank() == 0
    path = _join(directory, tag)
    if backend == "orbax":
        manifest, jobs = _sharded_jobs(zoo, writer)
    else:
        manifest = {"tables": {}, "version": 1}
        jobs = []
        for table_id, table in zoo.tables().items():
            if not hasattr(table, "store"):
                continue
            fname = f"{table.name}.{table_id}.mvt"
            manifest["tables"][str(table_id)] = dict(
                _manifest_entry(table), file=fname)
            if not writer and not getattr(table, "collective_store", True):
                continue
            if not block:
                job = _snapshot(table)
                if writer:
                    jobs.append((fname, *job))
            elif writer:
                with open_stream(_join(path, fname), "wb") as s:
                    table.store(s)
            else:
                table.store(_DevNull())
        if block:
            if writer:
                _write_manifest(path, manifest)
                log.info("checkpoint saved: %s (%d tables)", path,
                         len(manifest["tables"]))
            zoo.barrier()
            return path
    job = _SaveJob(path, manifest, jobs, writer=writer)
    if block:
        job.run()
        _commit(job)
        return path
    global _pending
    job.start()
    with _pending_lock:
        _pending = job
    return path


def restore(directory: str, tag: str = "checkpoint") -> int:
    """Load every registered table from a checkpoint written by
    :func:`save` (the stream format of either package, or the port's
    sharded one). Tables are matched by registration id and name;
    mismatched shapes raise; tables added since the save are left as
    they are. Stream format: every rank reads the whole of each table
    and a sharded table keeps this rank's block; a table saved at
    another block count (its padding differs) loads when its logical
    shape is this table's. Sharded format: each rank reads only the
    saved rows of its own block. An asynchronous save in flight is
    finalized first. Returns the number of tables restored."""
    from multiverso_tpu_torch.table import Table
    wait_pending()
    zoo = Zoo.get()
    path = _join(directory, tag)
    if not is_committed(path):
        raise ValueError(
            f"checkpoint {path} has no commit marker — the save was "
            "torn/partial (writer died mid-checkpoint); restore the "
            "previous committed tag instead")
    with open_stream(_join(path, "manifest.json"), "rb") as s:
        manifest = json.loads(s.read().decode())
    backend = manifest.get("backend", "stream")
    if backend == "orbax":
        return _restore_sharded(path, manifest)
    _check_backend(backend)
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
            if isinstance(table, Table) and "shape" in entry:
                # the logical rows: a table of another block count loads
                table.load(s, rows=int(entry["shape"][0]))
            else:
                table.load(s)
        restored += 1
    zoo.barrier()
    log.info("checkpoint restored: %s (%d tables)", path, restored)
    return restored


def _read_array(path: str) -> np.ndarray:
    """A saved array: memory-mapped where the file is local (only the
    bytes indexed are read), else read whole."""
    if is_local(path):
        return np.load(_local(path), mmap_mode="r", allow_pickle=False)
    with open_stream(path, "rb") as s:
        return np.load(io.BytesIO(s.read()), allow_pickle=False)


def _restore_sharded(path: str, manifest: Dict) -> int:
    """:func:`restore` of a sharded tag: each table with a device state
    loads its rank's block (``Table.load_blocks``), the others their
    stream files."""
    if manifest.get("layout") != LAYOUT:
        raise ValueError(
            f"checkpoint {path} is backend 'orbax' in layout "
            f"{manifest.get('layout')!r}, not the port's {LAYOUT!r}: a tag "
            "without a layout is orbax's own format, which the JAX package "
            "writes and the port does not read (orbax is a JAX library); "
            "save it with backend='stream', which both packages read")
    zoo = Zoo.get()
    tables = zoo.tables()
    for table_id, entry in manifest["tables"].items():
        table = tables.get(int(table_id))
        if table is not None and entry["name"] != table.name:
            raise ValueError(
                f"checkpoint table {table_id} is {entry['name']!r}, "
                f"registry has {table.name!r} — create tables in the same "
                "order before restoring")
    restored = 0
    for table_id, table in tables.items():
        entry = manifest["tables"].get(str(table_id))
        if entry is None:
            continue
        if entry.get("kind") == "orbax":
            if not hasattr(table, "load_blocks"):
                raise ValueError(f"checkpoint table {table_id} holds a "
                                 f"device state; {table.name!r} has none")
            tdir = _join(path, "arrays", f"table_{table_id}")
            with open_stream(_join(tdir, "index.json"), "rb") as s:
                index = json.loads(s.read().decode())
            table.load_blocks(index, lambda name, d=tdir: _read_array(
                _join(d, name)))
        elif hasattr(table, "load"):
            with open_stream(_join(path, entry["file"]), "rb") as s:
                table.load(s)
        else:
            continue
        restored += 1
    zoo.barrier()
    log.info("checkpoint restored (sharded): %s (%d tables)", path,
             restored)
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
        # ledger gauge: this save's owned host copies, released as each
        # shard's file lands
        staged = sum(int(getattr(a, "nbytes", 0)) for a in arrays)
        _GAUGES.stage(staged)
        try:
            _save_shard_file(os.path.join(path, fname), meta, arrays)
        finally:
            _GAUGES.unstage(staged)
        manifest["tables"][name] = {"file": fname,
                                    "kind": meta.get("kind"),
                                    "version": meta.get("version")}
        metas.append((shard, meta))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    _write_commit(path)
    _GAUGES.note_tag(base, _dir_bytes(path))
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
