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
environment) makes N processes one world: each keeps a replica of every
table, and the collective adds keep the replicas equal.

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
from multiverso_tpu_torch.tables import (ArrayTable, ArrayTableOption,
                                         KVTable, KVTableOption, MatrixTable,
                                         MatrixTableOption, SparseMatrixTable,
                                         SparseMatrixTableOption)
from multiverso_tpu_torch.updaters import AddOption, get_updater, register_updater
from multiverso_tpu_torch.utils import config, log
from multiverso_tpu_torch.utils.async_buffer import AsyncBuffer
from multiverso_tpu_torch.utils.dashboard import Dashboard, monitor
from multiverso_tpu_torch.zoo import Zoo

__all__ = [
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
