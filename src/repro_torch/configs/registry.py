"""Architecture registry of the port: `--arch <id>` resolution.

Only the archs the port runs resolve. Every other arch of the JAX
registry (repro.configs.registry) raises `KeyError` naming the ROADMAP
item that ports it.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchSpec

_ARCH_MODULES = {
    "bert4rec": "repro_torch.configs.bert4rec",
    "dien": "repro_torch.configs.dien",
    "dlrm-criteo": "repro_torch.configs.dlrm_criteo",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "wide-deep": "repro_torch.configs.wide_deep",
    "xdeepfm": "repro_torch.configs.xdeepfm",
}

# arch -> where it waits (ROADMAP.md, "Queue 1: modules to port")
_NOT_PORTED = {
    "qwen2-moe-a2.7b": "queue 1, item 8 (LLM family)",
    "kimi-k2-1t-a32b": "queue 1, item 8 (LLM family)",
    "smollm-135m": "queue 1, item 8 (LLM family)",
    "gemma2-2b": "queue 1, item 8 (LLM family)",
    "qwen2.5-32b": "queue 1, item 8 (LLM family)",
}


def list_archs() -> List[str]:
    """The archs the port runs."""
    return sorted(_ARCH_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in _NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported to repro_torch yet: "
                       f"ROADMAP.md {_NOT_PORTED[arch_id]}")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs "
                       f"{list_archs()}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).ARCH
