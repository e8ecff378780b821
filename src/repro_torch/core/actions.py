"""Action-space shaping (paper §4.3).

Direct allocation of n CPUs over r stages is C(n+r-1, r-1) (~1.2e7 for
128 CPUs / 5 stages) — intractable. InTune's incremental space gives each
stage one of {-5, -1, 0, +1, +5} per step -> 5^r joint actions (r <= 5 ->
<= 3125). Memory-bound knobs (prefetch buffer) move in MB units.

Two heads are provided:
  - "joint": one Q value per joint action (paper-faithful),
  - "factored": per-stage 5-way branches (branching dueling DQN, Tavakoli
    et al. 2018) — O(5r) outputs instead of O(5^r); a beyond-paper
    optimization benchmarked in §Perf.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

DELTAS = np.array([-5, -1, 0, 1, 5], dtype=np.int64)
N_CHOICES = len(DELTAS)
PREFETCH_MB_UNIT = 64.0  # memory-bound stages move in MB units


def n_joint_actions(n_stages: int) -> int:
    return N_CHOICES ** n_stages


def decode_joint(action: int, n_stages: int) -> np.ndarray:
    """Joint action index -> per-stage deltas (base-5 digits)."""
    out = np.zeros(n_stages, dtype=np.int64)
    for i in range(n_stages):
        out[i] = DELTAS[action % N_CHOICES]
        action //= N_CHOICES
    return out


def encode_joint(choices: np.ndarray) -> int:
    """Per-stage choice indices (0..4) -> joint action index."""
    a = 0
    for i in range(len(choices) - 1, -1, -1):
        a = a * N_CHOICES + int(choices[i])
    return a


def next_allocation(choices: np.ndarray, workers: np.ndarray,
                    prefetch_mb: float, *, prefetch_idx: int,
                    max_workers: int) -> Tuple[np.ndarray, float]:
    """Per-stage choice indices (0..4) -> next (workers, prefetch_mb).
    The one place action semantics are applied — env.step, the live
    executor path, and the Optimizer-protocol path all route through it."""
    deltas = DELTAS[np.asarray(choices, dtype=int)]
    return apply_deltas(workers, deltas, prefetch_idx=prefetch_idx,
                        prefetch_mb=prefetch_mb, max_workers=max_workers)


def apply_deltas(workers: np.ndarray, deltas: np.ndarray, *,
                 prefetch_idx: int, prefetch_mb: float,
                 max_workers: int) -> Tuple[np.ndarray, float]:
    """Apply per-stage deltas. The prefetch stage's delta moves its buffer
    in PREFETCH_MB_UNIT steps; others move CPU workers.

    Clamps: >= 1 worker per stage; total <= max_workers; buffer >= 1 batch.
    """
    new = workers.copy()
    new_pf = prefetch_mb
    for i, d in enumerate(deltas):
        if i == prefetch_idx:
            new_pf = max(PREFETCH_MB_UNIT, prefetch_mb + d * PREFETCH_MB_UNIT)
        else:
            new[i] = max(1, workers[i] + d)
    # respect the CPU cap: shed from the most-replicated stages first
    while new.sum() > max_workers:
        j = int(np.argmax(new))
        if new[j] <= 1:
            break
        new[j] -= 1
    return new, new_pf
