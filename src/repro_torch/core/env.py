"""RL environment for data-pipeline allocation (paper §4.1, Table 2).

Observation (Table 2):
  agent-modified:   per-stage pipeline latency, free CPUs, free memory
  uncorrelated:     model latency
  static:           DRAM-CPU bandwidth, CPU clock
Reward (Eq. 1):     R = throughput * (1 - mem_used / mem_total)
                    -> 0 as memory nears 100%; an OOM tick scores 0
                    throughput for the whole restart window, so the agent
                    learns the paper's no-OOM behavior from the reward
                    shape alone.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core import actions as act_lib
from repro_torch.data.pipeline import PipelineSpec
from repro_torch.data.simulator import Allocation, MachineSpec, PipelineSim


def even_allocation(spec: PipelineSpec, n_cpus: int) -> Allocation:
    """Even division across stages, done right: the `n_cpus % n_stages`
    remainder is distributed round-robin from the front instead of
    silently dropped, and when `n_stages > n_cpus` the total is capped at
    `n_cpus` (the old `max(1, ...)` floor oversubscribed the machine).
    Below one CPU per stage the trailing stages get 0 workers — a
    visibly starved (zero-throughput) pipeline instead of a silently
    oversubscribed one; such a machine cannot run the graph either way.

    Note this is NOT PipelineEnv's initial state: the paper initializes
    InTune from the even-division *heuristic baseline* (floor split,
    baselines.heuristic_even), and every published fig5/fig7 number
    started from that state, so the env keeps it bit-for-bit. New code
    (the fleet plane, pool splitting) uses this fixed version.
    """
    n = spec.n_stages
    base, rem = divmod(int(n_cpus), n)
    workers = np.full(n, base, dtype=int)
    workers[:rem] += 1
    return Allocation(workers, prefetch_mb=2 * spec.batch_mb)


def build_obs(sim: PipelineSim, alloc: Allocation) -> np.ndarray:
    """The Table-2 observation for one machine. This layout is a hard
    contract with the pretrained DQN weights (obs_dim = 2*n_stages + 6):
    PipelineEnv and FleetEnv both build observations HERE so the shared
    agents can never see diverging layouts."""
    m = sim.machine
    lat = sim.measured_latencies(alloc)
    free_cpus = m.n_cpus - int(np.sum(alloc.workers))
    free_mem = m.mem_mb - sim.memory_used(alloc)
    obs = np.concatenate([
        lat / (np.mean(lat) + 1e-9),              # relative latencies
        alloc.workers / 128.0,                    # current allocation
        [alloc.prefetch_mb / m.mem_mb,
         free_cpus / 128.0, free_mem / m.mem_mb,
         sim.model_latency,
         m.dram_bw_gbps / 100.0, m.cpu_ghz / 4.0]])
    return obs.astype(np.float32)


class PipelineEnv:
    """Steps the simulator under incremental allocation actions."""

    def __init__(self, spec: PipelineSpec, machine: MachineSpec,
                 model_latency: float = 0.0, seed: int = 0,
                 reward_scale: Optional[float] = None):
        self.spec = spec
        self.sim = PipelineSim(spec, machine, model_latency, seed=seed)
        self.prefetch_idx = next(
            (i for i, s in enumerate(spec.stages) if s.kind == "prefetch"),
            spec.n_stages - 1)
        # normalize rewards by the oracle throughput so the scale is
        # comparable across random pipelines during offline pretraining
        if reward_scale is None:
            _, best = self.sim.best_allocation()
            reward_scale = max(best, 1e-6)
        self.reward_scale = reward_scale
        # the paper's initialization: the even-division heuristic baseline
        # (floor split — the state every published benchmark starts from)
        from repro_torch.core.baselines import heuristic_even
        self.alloc = heuristic_even(spec, machine)
        self.last_metrics = self.sim.apply(self.alloc)

    @property
    def obs_dim(self) -> int:
        # per-stage: relative latency + current workers; globals: prefetch
        # buffer frac, free CPUs, free memory, model latency, DRAM bw, GHz
        return 2 * self.spec.n_stages + 6

    def observe(self) -> np.ndarray:
        return build_obs(self.sim, self.alloc)

    def step(self, choices: np.ndarray) -> Tuple[np.ndarray, float, dict]:
        """choices: per-stage indices into DELTAS. Returns (obs, r, info)."""
        workers, pf = act_lib.next_allocation(
            choices, self.alloc.workers, self.alloc.prefetch_mb,
            prefetch_idx=self.prefetch_idx,
            max_workers=self.sim.machine.n_cpus)
        self.alloc = Allocation(workers, pf)
        metrics = self.sim.apply(self.alloc)
        self.last_metrics = metrics
        mem_frac = min(metrics["mem_mb"] / self.sim.machine.mem_mb, 1.0)
        reward = (metrics["throughput"] / self.reward_scale) * (1 - mem_frac)
        return self.observe(), float(reward), metrics

    def resize(self, n_cpus: int):
        self.sim.resize(n_cpus)

    def set_allocation(self, alloc: Allocation):
        self.alloc = alloc.copy()
        self.last_metrics = self.sim.apply(self.alloc)


class FleetEnv:
    """Cluster-granularity environment: steps a FleetSim under
    FleetAllocations and reports per-trainer observations in the same
    Table-2 layout PipelineEnv builds for one machine.

    Reward is the fleet analog of Eq. 1, summed over active trainers and
    normalized by the analytic fleet-oracle throughput of the initial
    state, so the scale is comparable across cluster specs:

        R = sum_i tput_i * (1 - mem_used_i / mem_total_i) / oracle_fleet
    """

    def __init__(self, cluster, seed: int = 0):
        from repro_torch.core import baselines as B
        from repro_torch.data.fleet import FleetAllocation, FleetSim
        self.cluster = cluster
        self.sim = FleetSim(cluster, seed=seed)
        state = self.sim.machine
        ideal = B.fleet_oracle(cluster, state)
        self.reward_scale = max(sum(
            B._oracle_point(cluster.trainer(n),
                            state.base(n) + ideal.grants.get(n, 0))[1]
            for n in state.active), 1e-6)
        # neutral start: even pool split, fixed even division per machine
        grants = B._even_grants(state.pool, state.active)
        self.falloc = FleetAllocation(
            {n: even_allocation(cluster.trainer(n).pipeline,
                                state.base(n) + grants[n])
             for n in state.active}, grants)
        self.last_metrics = None

    @property
    def state(self):
        return self.sim.machine

    def observe(self) -> dict:
        """{trainer: obs} for every active trainer, PipelineEnv layout
        (built by the same build_obs the single-machine env uses)."""
        out = {}
        state = self.sim.machine
        for name in state.active:
            alloc = self.falloc.allocs.get(name) or even_allocation(
                self.cluster.trainer(name).pipeline, state.base(name))
            out[name] = build_obs(self.sim.sims[name], alloc)
        return out

    def step(self, falloc) -> Tuple[dict, float, dict]:
        self.falloc = falloc
        metrics = self.sim.apply(falloc)
        self.last_metrics = metrics
        reward = 0.0
        for name, m in metrics["per_trainer"].items():
            mem_total = self.cluster.trainer(name).machine.mem_mb
            mem_frac = min(m["mem_mb"] / mem_total, 1.0)
            reward += m["throughput"] * (1.0 - mem_frac)
        reward /= self.reward_scale
        return self.observe(), float(reward), metrics
