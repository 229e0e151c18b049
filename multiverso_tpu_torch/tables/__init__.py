from multiverso_tpu_torch.tables.array_table import ArrayTable, ArrayTableOption
from multiverso_tpu_torch.tables.kv_table import KVTable, KVTableOption
from multiverso_tpu_torch.tables.matrix_table import (MatrixTable,
                                                      MatrixTableOption)
from multiverso_tpu_torch.tables.sparse_matrix_table import (
    SparseMatrixTable, SparseMatrixTableOption)

__all__ = ["ArrayTable", "ArrayTableOption", "KVTable", "KVTableOption",
           "MatrixTable", "MatrixTableOption", "SparseMatrixTable",
           "SparseMatrixTableOption"]
