"""multiverso_tpu_torch: the PyTorch/CUDA port of ``multiverso_tpu``.

Parameter tables with server-side updaters on one ``torch.device`` (array,
matrix, sparse matrix and KV tables), the shared-parameter delta sync, the
transformer LM whose attention is hand-written CUDA
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) with its KV-cache decode
and int8 weights (``models/transformer.generate``,
``ops/quantization.py``, ``io/lm_data.py``), WordEmbedding
(``apps/word_embedding.py``), LogisticRegression
(``apps/logistic_regression.py``), ResNet-CIFAR
(``apps/resnet_cifar.py``), the LDA topic model (``models/lda.py``), and
the async parameter-server plane (``ps/``: uncoordinated Add/Get against
tables sharded over processes). ``net_init()`` (or a launcher's
environment) makes N processes one world: the synchronous tables shard
their rows over its ranks (``Table.sharding``), and every add, Get and
row read is a collective.

Entry points run on the card: ``init()`` resolves the device to ``cuda``
and raises if there is none, unless the caller passes ``device="cpu"``.
This package imports neither ``jax`` nor ``multiverso_tpu``.
"""

from multiverso_tpu_torch.api import (
    MV_Aggregate, MV_Barrier, MV_CreateTable, MV_Init, MV_NumServers,
    MV_NumWorkers, MV_Rank, MV_ServerId, MV_ServerIdToRank, MV_ShutDown,
    MV_Size, MV_WorkerId, MV_WorkerIdToRank, aggregate, barrier,
    create_table, device, init, is_master_worker, mesh, net_init,
    num_servers, num_workers, rank, server_id, server_id_to_rank,
    servers_num, shutdown, size, worker_id, worker_id_to_rank, workers_num)
from multiverso_tpu_torch.ps import (AsyncArrayTable, AsyncKVTable,
                                     AsyncMatrixTable, AsyncSparseKVTable,
                                     AsyncSparseMatrixTable)
from multiverso_tpu_torch.sharedvar import SharedPytree
from multiverso_tpu_torch.table import Table
from multiverso_tpu_torch.tables import (ArrayTable, ArrayTableOption,
                                         KVTable, KVTableOption, MatrixTable,
                                         MatrixTableOption, SparseMatrixTable,
                                         SparseMatrixTableOption)
from multiverso_tpu_torch.updaters import (AdaGradUpdater, AdamUpdater,
                                           AddOption, MomentumUpdater,
                                           SGDUpdater, Updater, get_updater,
                                           register_updater)
from multiverso_tpu_torch import serving, telemetry
from multiverso_tpu_torch.utils import config, dashboard, log
from multiverso_tpu_torch.utils.async_buffer import AsyncBuffer
from multiverso_tpu_torch.utils.dashboard import Dashboard, monitor
from multiverso_tpu_torch.zoo import Zoo

__version__ = "0.1.0"

# submodules reached as attributes and imported at first use, as the JAX
# package's are (each imports this package itself)
_LAZY = ("checkpoint", "parallel", "handlers", "sharedvar", "native",
         "models", "apps", "io", "data", "ssp", "elastic", "torch_ext")


def __getattr__(name):
    import importlib
    if name in _LAZY:
        return importlib.import_module(f"multiverso_tpu_torch.{name}")
    raise AttributeError(
        f"module 'multiverso_tpu_torch' has no attribute {name!r}")


__all__ = [
    "__version__", "Table", "Updater", "SGDUpdater", "MomentumUpdater",
    "AdaGradUpdater", "AdamUpdater", "serving", "telemetry", "dashboard",
    "MV_Aggregate", "MV_Barrier", "MV_CreateTable", "MV_Init",
    "MV_NumServers", "MV_NumWorkers", "MV_Rank", "MV_ServerId",
    "MV_ServerIdToRank", "MV_ShutDown", "MV_Size", "MV_WorkerId",
    "MV_WorkerIdToRank", "aggregate", "net_init", "server_id_to_rank",
    "servers_num", "worker_id_to_rank", "workers_num",
    "AddOption", "ArrayTable", "ArrayTableOption", "AsyncArrayTable",
    "AsyncBuffer", "AsyncKVTable", "AsyncMatrixTable", "AsyncSparseKVTable",
    "AsyncSparseMatrixTable",
    "Dashboard", "KVTable", "KVTableOption", "MatrixTable",
    "MatrixTableOption", "SharedPytree", "SparseMatrixTable",
    "SparseMatrixTableOption", "Zoo", "barrier", "config", "create_table", "device", "get_updater",
    "init", "is_master_worker", "log", "mesh", "monitor", "num_servers",
    "num_workers", "rank", "register_updater", "server_id", "shutdown",
    "size", "worker_id",
]
