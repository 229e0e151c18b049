"""The uncoordinated cross-process parameter-server plane (port of
``multiverso_tpu/ps/``).

Workers push (``Add``) and pull (``Get``) against sharded tables at their
own rates, with no barrier (ref src/worker.cpp:30-76 partitions a request
per server; src/server.cpp:36-58 applies whatever arrives, whenever it
arrives):

* every process runs a :class:`~multiverso_tpu_torch.ps.service.PSService`
  — a listener thread + per-connection handler threads;
* every process owns a contiguous row range of each async table as a
  shard on its device (:class:`~multiverso_tpu_torch.ps.shard.RowShard`,
  the card unless the caller asks for the CPU); the updater runs there,
  and only the row payloads ride TCP;
* clients partition each Add/Get by owner rank and talk directly to the
  owners, local shards short-circuiting the socket;
* the frames are byte for byte the JAX package's (``ps/wire.py``), so a
  rank of either package reads the other's traffic;
* the wire's hot path is native (``csrc/mv_ps.cpp`` via
  :mod:`multiverso_tpu_torch.ps.native`, flag ``ps_native``, on by
  default): C++ connection threads serve row ops on host-backed linear
  shards (rows in a CPU tensor) with no Python in the loop, clients fan
  batches out per owner and scatter get replies in C, and anything the
  C++ side cannot serve — every op on a shard on the card — punts to the
  Python handlers synchronously under the same per-shard mutex. The JAX
  package reports 2-3.8x the pure-Python plane's throughput on a CPU
  host's loopback; the card's numbers are in PERF.md;
* ranks of one world in one process may skip the socket (flag
  ``ps_fanout``: requests to a colocated rank run inline in its handler,
  and a multi-owner row op rides one in-process ``MSG_MULTI``
  super-frame), and their shards of one table on one device may stack
  into one tensor with one grouped apply and gather a round (flag
  ``ps_spmd_stack``), both in :mod:`multiverso_tpu_torch.ps.spmd`.

No barrier, no allgather: a dead worker never blocks peers — requests to
its shard fail with :class:`PSPeerError` after a timeout while traffic to
live shards proceeds, socket deaths tombstone the rank
(``elastic.bind_ps``), and ``mv.shutdown`` quiesces (each rank keeps
serving until live peers are done).
"""

from multiverso_tpu_torch.ps.service import (PSContext, PSError,
                                             PSPeerError, PSService,
                                             default_context,
                                             reset_default_context)
from multiverso_tpu_torch.ps.tables import (AsyncArrayTable,
                                            AsyncArrayTableOption,
                                            AsyncKVTable, AsyncMatrixTable,
                                            AsyncMatrixTableOption,
                                            AsyncSparseKVTable,
                                            AsyncSparseMatrixTable)

__all__ = [
    "AsyncArrayTable", "AsyncArrayTableOption", "AsyncKVTable",
    "AsyncMatrixTable", "AsyncMatrixTableOption", "AsyncSparseKVTable",
    "AsyncSparseMatrixTable",
    "PSContext", "PSError", "PSPeerError", "PSService",
    "default_context", "reset_default_context",
]
