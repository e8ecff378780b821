"""Early allocation validation with errors that name the actual mistake.

A negative worker count or a workers vector of the wrong length used to
fail deep inside `PipelineSim.apply` (a nonsense service rate, a numpy
broadcast error) or `ThreadedPipeline.set_allocation` (a silent zip
truncation); a negative prefetch budget quietly produced a negative
memory footprint. Backends validate every proposal at the API boundary
instead, so a policy bug surfaces as an `AllocationError` naming the
offending field.
"""
from __future__ import annotations

from typing import Any

import numpy as np


class AllocationError(ValueError):
    """A proposed Allocation/FleetAllocation is structurally invalid."""


def validate_allocation(spec: Any, alloc: Any) -> None:
    """Reject structurally invalid single-machine Allocations.

    spec: a StageGraph (anything with n_stages); alloc: an Allocation
    (workers + prefetch_mb). Raises AllocationError; returns None on a
    valid allocation.
    """
    workers = np.asarray(alloc.workers)
    if workers.ndim != 1:
        raise AllocationError(
            f"allocation workers must be a 1-D vector, got shape "
            f"{workers.shape}")
    if len(workers) != spec.n_stages:
        raise AllocationError(
            f"allocation has {len(workers)} worker counts but "
            f"{getattr(spec, 'name', 'spec')!r} has {spec.n_stages} stages")
    if not np.issubdtype(workers.dtype, np.integer):
        raise AllocationError(
            f"worker counts must be integers, got dtype {workers.dtype}")
    if (workers < 0).any():
        bad = int(np.argmin(workers))
        raise AllocationError(
            f"negative worker count {int(workers[bad])} for stage "
            f"{spec.stages[bad].name!r}")
    if alloc.prefetch_mb < 0:
        raise AllocationError(
            f"prefetch_mb must be >= 0, got {alloc.prefetch_mb}")


def validate_fleet_allocation(cluster: Any, falloc: Any) -> None:
    """Reject structurally invalid FleetAllocations: every per-trainer
    Allocation is validated against that trainer's pipeline, and grants
    must be non-negative. (Grant totals vs the pool stay the backend's
    contract — they depend on dynamic pool state.)"""
    trainers = {t.name: t for t in cluster.trainers}
    for name, alloc in falloc.allocs.items():
        trainer = trainers.get(name)
        if trainer is None:
            raise AllocationError(
                f"allocation names unknown trainer {name!r}; known: "
                f"{sorted(trainers)}")
        try:
            validate_allocation(trainer.pipeline, alloc)
        except AllocationError as e:
            raise AllocationError(f"trainer {name!r}: {e}") from None
    for name, g in falloc.grants.items():
        if int(g) < 0:
            raise AllocationError(
                f"negative pool grant {int(g)} for trainer {name!r}")
