"""Architecture registry of the port: `--arch <id>` resolution.

Every arch of the JAX registry (repro.configs.registry) resolves. The
archs whose full-width runs do not fit one device wait on distribution:
`ONE_DEVICE_LIMIT` is the wording of that refusal, which the generic
driver's `--full` raises before it allocates anything.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchSpec

_ARCH_MODULES = {
    # LM family
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    # GNN
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    # RecSys
    "wide-deep": "repro_torch.configs.wide_deep",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "dien": "repro_torch.configs.dien",
    "bert4rec": "repro_torch.configs.bert4rec",
    # The paper's own workload (Criteo DLRM)
    "dlrm-criteo": "repro_torch.configs.dlrm_criteo",
}

# where a run too large for one device waits (ROADMAP.md, "Queue 1:
# modules to port")
ONE_DEVICE_LIMIT = "ROADMAP.md queue 1, item 9 (distribution and launch)"


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs "
                       f"{list_archs()}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).ARCH
