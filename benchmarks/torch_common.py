"""Shared benchmark machinery of the PyTorch port (the counterpart of
benchmarks/common.py): cached pretrained agents and output helpers.

Agents are pretrained by `repro_torch.core.pretrain` and cached as
`dqn_{head}_r{n}.npz` in the JAX package's npz layout, under `build/`
in the checkout, which git ignores: the JAX package's own cache,
`experiments/agents/`, is never written. Benchmark JSON goes to
`build/bench/`.

`make_fleet_coordinator` and `make_pool_market` build the fleet plane's
RL policies over the same cache, one agent per pipeline length in the
cluster (5 and 7 for `demo_cluster`). `ReadaptPolicy` is the
*-Adaptive protocol of the single-machine rescale benchmark
(`benchmarks/torch_fig7_rescale.py`).
"""
from __future__ import annotations

import json
import os

from repro_torch.api import FrozenPolicy, RELAUNCH_TICKS
from repro_torch.core.controller import InTune
from repro_torch.core.pretrain import load_agent_state, pretrain, save_agent
from repro_torch.data.simulator import Allocation

_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "build")
AGENT_DIR = os.path.join(_BUILD, "agents")
OUT_DIR = os.path.join(_BUILD, "bench")

__all__ = ["AGENT_DIR", "OUT_DIR", "RELAUNCH_TICKS", "ReadaptPolicy",
           "get_agent_state", "save_json", "make_tuner",
           "make_fleet_coordinator", "make_pool_market"]


def get_agent_state(n_stages: int, head: str = "factored",
                    episodes: int = 60, ticks: int = 300) -> dict:
    """The pretrained agent for `n_stages`-stage pipelines: loaded from
    the cache, or pretrained on the analytic simulator and cached."""
    os.makedirs(AGENT_DIR, exist_ok=True)
    path = os.path.join(AGENT_DIR, f"dqn_{head}_r{n_stages}.npz")
    if os.path.exists(path):
        return load_agent_state(path)
    agent = pretrain(n_stages, episodes=episodes, ticks=ticks,
                     verbose=False, head=head)
    save_agent(agent, path)
    return agent.state_dict()


def save_json(name: str, payload):
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(payload, f, indent=1, default=float)


class ReadaptPolicy(FrozenPolicy):
    """The *-Adaptive benchmark protocol: hold `alloc` (FrozenPolicy);
    on every scheduled resize tick, re-profile via `readapt(spec,
    machine, seed + tick)` — the manual checkpoint+relaunch behavior,
    whose dead window the caller schedules as DeadWindow events. With
    `readapt=None` this IS FrozenPolicy."""

    name = "static"

    def __init__(self, alloc: Allocation, readapt=None, *, seed: int = 0,
                 resize_ticks=()):
        super().__init__(alloc)
        self._readapt = readapt
        self._seed = seed
        self._resize_ticks = frozenset(resize_ticks)
        self._t = 0

    def propose(self, spec, machine, stats=None) -> Allocation:
        t = self._t
        self._t += 1
        if self._readapt is not None and t in self._resize_ticks:
            self.alloc = self._readapt(spec, machine, self._seed + t)
        return self.alloc


def _pretrained(trainers, head: str) -> dict:
    """One cached pretrained agent state per distinct pipeline length."""
    lengths = sorted({t.pipeline.n_stages for t in trainers})
    return {n: get_agent_state(n, head=head) for n in lengths}


def make_fleet_coordinator(cluster, *, seed: int = 0, head: str = "factored",
                           finetune_ticks: int = 150, **kw):
    """Benchmark-grade FleetCoordinator: one cached pretrained agent per
    distinct pipeline length in the cluster."""
    from repro_torch.core.fleet_coordinator import FleetCoordinator
    return FleetCoordinator(cluster, pretrained=_pretrained(
        cluster.trainers, head), seed=seed, head=head,
        finetune_ticks=finetune_ticks, **kw)


def make_pool_market(market, *, seed: int = 0, head: str = "factored",
                     finetune_ticks: int = 150, **kw):
    """Benchmark-grade PoolMarket ("coordinator + market"): per-job
    FleetCoordinators, one cached pretrained agent per distinct pipeline
    length across the whole market."""
    from repro_torch.core.fleet_coordinator import PoolMarket
    return PoolMarket(market, inner="fleet_intune", pretrained=_pretrained(
        market.trainers, head), seed=seed, head=head,
        finetune_ticks=finetune_ticks, **kw)


def make_tuner(spec, machine, *, seed: int = 0, head: str = "factored",
               finetune_ticks: int = 250, **kw) -> InTune:
    """Benchmark-grade InTune: pretrained (cached) agent for this length."""
    state = get_agent_state(spec.n_stages, head=head)
    return InTune(spec, machine, seed=seed, head=head, pretrained=state,
                  finetune_ticks=finetune_ticks, **kw)
