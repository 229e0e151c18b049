"""ArrayTable: 1-D dense parameter vector (port of
``multiverso_tpu/tables/array_table.py``). One device holds the whole
vector; sharding across cards arrives with the multi-card slice."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from multiverso_tpu_torch import updaters as updaters_lib
from multiverso_tpu_torch.table import Table


class ArrayTable(Table):
    def __init__(self, size: int, dtype=np.float32,
                 updater: Union[str, updaters_lib.Updater, None] = None,
                 name: str = "array",
                 init=None, seed: Optional[int] = None,
                 init_scale: float = 0.0, wire_filter: str = "none"):
        super().__init__((int(size),), dtype=dtype, updater=updater,
                         name=name, init=init, seed=seed,
                         init_scale=init_scale, wire_filter=wire_filter)

    @property
    def size(self) -> int:
        return self.shape[0]


class ArrayTableOption:
    """ref DEFINE_TABLE_TYPE option struct:
    ``create_table(ArrayTableOption(size))``."""

    def __init__(self, size: int, dtype=np.float32, updater=None,
                 init=None, seed=None, init_scale: float = 0.0):
        self.size = size
        self.dtype = dtype
        self.updater = updater
        self.init = init
        self.seed = seed
        self.init_scale = init_scale

    def build(self, name: str = "array") -> ArrayTable:
        return ArrayTable(self.size, dtype=self.dtype, updater=self.updater,
                          name=name, init=self.init, seed=self.seed,
                          init_scale=self.init_scale)
