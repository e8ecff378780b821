"""Offline agent pretraining (paper §4.2), the port of repro/core/pretrain.py.

"We train different versions of the agent in offline simulations ... Each
version is built for a different common pipeline length (e.g. one agent for
4-stage pipelines, one for 5-stage, etc)." — this module is that pass:
episodes over randomized PipelineSpecs of a fixed length, machine sizes
sampled per episode, occasional mid-episode resizes so the agent sees the
rescale dynamics it must handle live. The DQN runs on the CPU (as
core/agent.py keeps it), on the analytic simulator.

    python -m repro_torch.core.pretrain --stages 5 --episodes 60 --out agents/

Agents are saved in the JAX package's npz layout (`qnet/<layer>/<k>`,
`steps`), so a file written by either package loads into the other and
into `InTune(pretrained=load_agent_state(path))`.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.core.agent import DQNAgent, DQNConfig
from repro_torch.core.env import PipelineEnv
from repro_torch.data.pipeline import make_pipeline
from repro_torch.data.simulator import MachineSpec


def pretrain(n_stages: int, episodes: int = 60, ticks: int = 300,
             seed: int = 0, verbose: bool = True,
             head: str = "joint") -> DQNAgent:
    rng = np.random.RandomState(seed)
    agent = None
    for ep in range(episodes):
        spec = make_pipeline(n_stages, seed=rng.randint(1 << 30))
        machine = MachineSpec(
            n_cpus=int(rng.choice([32, 64, 96, 128])),
            mem_mb=float(rng.choice([16384, 32768, 65536])))
        model_lat = float(rng.choice([0.0, 0.02, 0.05]))
        env = PipelineEnv(spec, machine, model_lat, seed=ep)
        if agent is None:
            agent = DQNAgent(DQNConfig(obs_dim=env.obs_dim,
                                       n_stages=n_stages, head=head),
                             seed=seed)
        obs = env.observe()
        resize_at = ticks // 2 if rng.rand() < 0.5 else -1
        ep_reward = 0.0
        for t in range(ticks):
            if t == resize_at:
                env.resize(int(rng.choice([32, 64, 128])))
            a = agent.act(obs)
            nobs, r, _ = env.step(a)
            agent.observe(obs, a, r, nobs, done=(t == ticks - 1))
            obs = nobs
            ep_reward += r
        if verbose and (ep + 1) % 10 == 0:
            print(f"[pretrain r={n_stages}] episode {ep + 1}/{episodes} "
                  f"mean reward {ep_reward / ticks:.3f} "
                  f"eps {agent.epsilon():.2f}")
    return agent


def save_agent(agent: DQNAgent, path: str):
    state = agent.state_dict()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {f"qnet/{layer}/{k}": v
            for layer, p in state["qnet"].items() for k, v in p.items()}
    np.savez(path, steps=state["steps"], **flat)


def load_agent_state(path: str) -> dict:
    z = np.load(path)
    qnet: dict = {}
    for key in z.files:
        if key.startswith("qnet/"):
            _, layer, k = key.split("/")
            qnet.setdefault(layer, {})[k] = z[key]
    return {"qnet": qnet, "steps": int(z["steps"])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", type=int, default=5)
    ap.add_argument("--episodes", type=int, default=60)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--out", default="experiments/agents")
    args = ap.parse_args(argv)
    t0 = time.time()  # lint: allow[sim-wall-clock] -- log-only: feeds the elapsed-time print below, never a score
    agent = pretrain(args.stages, args.episodes, args.ticks)
    path = os.path.join(args.out, f"dqn_r{args.stages}.npz")
    save_agent(agent, path)
    # lint: allow[sim-wall-clock] -- log-only: wall time printed for the operator, not recorded anywhere
    print(f"saved {path} ({time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
