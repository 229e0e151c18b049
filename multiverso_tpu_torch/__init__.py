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
tables sharded over processes).

Entry points run on the card: ``init()`` resolves the device to ``cuda``
and raises if there is none, unless the caller passes ``device="cpu"``.
This package imports neither ``jax`` nor ``multiverso_tpu``.
"""

from multiverso_tpu_torch.api import (barrier, create_table, device, init,
                                      is_master_worker, num_servers,
                                      num_workers, rank, server_id, shutdown,
                                      size, worker_id)
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
    "AddOption", "ArrayTable", "ArrayTableOption", "AsyncArrayTable",
    "AsyncBuffer", "AsyncKVTable", "AsyncMatrixTable", "AsyncSparseKVTable",
    "AsyncSparseMatrixTable",
    "Dashboard", "KVTable", "KVTableOption", "MatrixTable",
    "MatrixTableOption", "SharedPytree", "SparseMatrixTable",
    "SparseMatrixTableOption", "Zoo", "barrier", "config", "create_table", "device", "get_updater",
    "init", "is_master_worker", "log", "monitor", "num_servers",
    "num_workers", "rank", "register_updater", "server_id", "shutdown",
    "size", "worker_id",
]
