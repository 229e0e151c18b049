"""The uncoordinated cross-process parameter-server plane (port of
``multiverso_tpu/ps/``, its pure-Python wire plane).

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
  rank of either package reads the other's traffic.

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
