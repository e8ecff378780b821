"""Config dataclasses of the port (copied from repro.configs.base).

Frozen so configs are hashable. `reduced` lists every cut a config
makes against its published source, each with its reason.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_sparse: int = 26
    n_dense: int = 13
    embed_dim: int = 128
    vocab_sizes: Tuple[int, ...] = ()
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    param_dtype: str = "float32"
    reduced: Tuple[str, ...] = ()

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
