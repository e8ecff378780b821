"""Shared benchmark machinery of the PyTorch port (the counterpart of
benchmarks/common.py): cached pretrained agents and output helpers.

Agents are pretrained by `repro_torch.core.pretrain` and cached as
`dqn_{head}_r{n}.npz` in the JAX package's npz layout, under `build/`
in the checkout, which git ignores: the JAX package's own cache,
`experiments/agents/`, is never written. Benchmark JSON goes to
`build/bench/`.

The fleet helpers of benchmarks/common.py (`make_fleet_coordinator`,
`make_pool_market`, `ReadaptPolicy`) need the fleet plane, which the
port does not have yet.
"""
from __future__ import annotations

import json
import os

from repro_torch.api import RELAUNCH_TICKS
from repro_torch.core.controller import InTune
from repro_torch.core.pretrain import load_agent_state, pretrain, save_agent

_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "build")
AGENT_DIR = os.path.join(_BUILD, "agents")
OUT_DIR = os.path.join(_BUILD, "bench")

__all__ = ["AGENT_DIR", "OUT_DIR", "RELAUNCH_TICKS", "get_agent_state",
           "save_json", "make_tuner"]


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


def make_tuner(spec, machine, *, seed: int = 0, head: str = "factored",
               finetune_ticks: int = 250, **kw) -> InTune:
    """Benchmark-grade InTune: pretrained (cached) agent for this length."""
    state = get_agent_state(spec.n_stages, head=head)
    return InTune(spec, machine, seed=seed, head=head, pretrained=state,
                  finetune_ticks=finetune_ticks, **kw)
