from multiverso_tpu_torch.tables.array_table import ArrayTable, ArrayTableOption

__all__ = ["ArrayTable", "ArrayTableOption"]
