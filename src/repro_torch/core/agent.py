"""DQN agent in PyTorch (paper §4.2; port of repro/core/agent.py).

Three-layer MLP Q-network ("a simple three-layer MLP architecture"),
epsilon-greedy exploration, uniform replay, target network, Huber TD loss,
optional double-DQN. Joint 5^r head (faithful) or factored branching head
(Q(s, a) = mean over per-stage branch Q's).

The TD update is SGD with momentum 0.9 and no dampening, the JAX
package's `m = 0.9 m + g; p -= lr m`. Exploration draws from the same
seeded `np.random.RandomState` as the reference, so a port agent and a
JAX agent with the same weights take the same actions.

The Q-network runs on the CPU: it is a few thousand parameters, and
every action is a host decision, so a device would only add a round trip
per tick. `state_dict()` keeps the JAX layout (`{"qnet": {"l1": {"w":
(in, out), "b": (out,)}, ...}}`), so `experiments/agents/dqn_*.npz`
loads into both packages.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.actions import N_CHOICES, n_joint_actions

_LAYERS = ("l1", "l2", "l3")


@dataclass
class DQNConfig:
    obs_dim: int = 10
    n_stages: int = 5
    head: str = "joint"          # "joint" | "factored"
    hidden: int = 128
    lr: float = 1e-3
    gamma: float = 0.95
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 2000
    buffer_size: int = 50_000
    batch_size: int = 64
    target_update: int = 200
    double_dqn: bool = True

    @property
    def n_outputs(self) -> int:
        if self.head == "joint":
            return n_joint_actions(self.n_stages)
        return self.n_stages * N_CHOICES


class QNet(nn.Module):
    """obs (..., obs_dim) -> joint Q values (..., 5^r), or branch values
    (..., r, 5) for the factored head."""

    def __init__(self, cfg: DQNConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        for name, (i, o) in zip(_LAYERS, ((cfg.obs_dim, h), (h, h),
                                          (h, cfg.n_outputs))):
            lin = nn.Linear(i, o, device="meta").to_empty(device="cpu")
            with torch.no_grad():
                lin.weight.normal_(generator=generator).mul_(i ** -0.5)
                lin.bias.zero_()
            setattr(self, name, lin)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.l1(obs))
        x = torch.relu(self.l2(x))
        out = self.l3(x)
        if self.cfg.head == "joint":
            return out
        return out.reshape(out.shape[:-1] + (self.cfg.n_stages, N_CHOICES))


def init_qnet(cfg: DQNConfig, seed: int = 0) -> QNet:
    return QNet(cfg, torch.Generator().manual_seed(seed))


def qnet_apply(qnet: QNet, obs, cfg: DQNConfig) -> torch.Tensor:
    return qnet(torch.as_tensor(obs, dtype=torch.float32))


@torch.no_grad()
def greedy_action(qnet: QNet, obs, cfg: DQNConfig) -> np.ndarray:
    """Returns per-stage choice indices (r,) in 0..4."""
    q = qnet_apply(qnet, obs, cfg)
    if cfg.head == "joint":
        a = int(torch.argmax(q))
        out = np.zeros(cfg.n_stages, dtype=np.int64)
        for i in range(cfg.n_stages):
            out[i] = a % N_CHOICES
            a //= N_CHOICES
        return out
    return torch.argmax(q, dim=-1).numpy()


def qnet_from_numpy(qnet: dict) -> Dict[str, torch.Tensor]:
    """JAX-layout {"l1": {"w": (in, out), "b"}, ...} (or flat "l1/w"
    keys) -> a `QNet.state_dict()`."""
    out = {}
    for layer in _LAYERS:
        for k, name in (("w", "weight"), ("b", "bias")):
            v = qnet[layer][k] if isinstance(qnet.get(layer), dict) \
                else qnet[f"{layer}/{k}"]
            v = np.asarray(v, np.float32)
            out[f"{layer}.{name}"] = torch.from_numpy(
                np.array(v.T, order="C") if k == "w" else v.copy())
    return out


def qnet_to_numpy(qnet: QNet) -> dict:
    """The Q-network's weights in the JAX layout."""
    return {layer: {"w": np.ascontiguousarray(
                        getattr(qnet, layer).weight.detach().numpy().T),
                    "b": getattr(qnet, layer).bias.detach().numpy().copy()}
            for layer in _LAYERS}


class Replay:
    def __init__(self, cfg: DQNConfig):
        n = cfg.buffer_size
        self.obs = np.zeros((n, cfg.obs_dim), np.float32)
        self.act = np.zeros((n, cfg.n_stages), np.int64)   # per-stage choices
        self.rew = np.zeros((n,), np.float32)
        self.nobs = np.zeros((n, cfg.obs_dim), np.float32)
        self.done = np.zeros((n,), np.float32)
        self.idx = 0
        self.full = False
        self.cap = n

    def add(self, o, a, r, no, d):
        i = self.idx
        self.obs[i], self.act[i], self.rew[i] = o, a, r
        self.nobs[i], self.done[i] = no, d
        self.idx = (i + 1) % self.cap
        self.full = self.full or self.idx == 0

    def __len__(self):
        return self.cap if self.full else self.idx

    def sample(self, rng: np.random.RandomState, batch: int):
        n = len(self)
        ix = rng.randint(0, n, size=batch)
        return (self.obs[ix], self.act[ix], self.rew[ix], self.nobs[ix],
                self.done[ix])


def _joint_index(act_choices: torch.Tensor, n_stages: int) -> torch.Tensor:
    """(B, r) per-stage choices -> (B,) joint indices."""
    idx = torch.zeros(act_choices.shape[0], dtype=torch.int64)
    for i in range(n_stages - 1, -1, -1):
        idx = idx * N_CHOICES + act_choices[:, i]
    return idx


def make_td_update(cfg: DQNConfig):
    """TD step: update(qnet, target, opt, obs, act, rew, nobs, done) ->
    loss; `opt` is the agent's SGD over qnet's parameters."""

    def q_of(qnet, obs, act):
        q = qnet(obs)
        if cfg.head == "joint":
            ji = _joint_index(act, cfg.n_stages)
            return q.gather(1, ji[:, None])[:, 0]
        per = q.gather(-1, act[..., None])[..., 0]         # (B, r)
        return per.mean(-1)

    @torch.no_grad()
    def max_q(target, sel, obs):
        q_sel = sel(obs)
        q_eval = target(obs)
        a_star = torch.argmax(q_sel, dim=-1)
        if cfg.head == "joint":
            return q_eval.gather(1, a_star[:, None])[:, 0]
        return q_eval.gather(-1, a_star[..., None])[..., 0].mean(-1)

    def update(qnet, target, opt, obs, act, rew, nobs, done):
        obs, rew, nobs, done = (torch.as_tensor(x, dtype=torch.float32)
                                for x in (obs, rew, nobs, done))
        act = torch.as_tensor(act, dtype=torch.int64)
        q_sa = q_of(qnet, obs, act)
        q_next = max_q(target, qnet if cfg.double_dqn else target, nobs)
        y = rew + cfg.gamma * (1.0 - done) * q_next
        err = q_sa - y
        huber = torch.where(err.abs() < 1.0, 0.5 * err ** 2,
                            err.abs() - 0.5)
        loss = huber.mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return float(loss.detach())

    return update


class DQNAgent:
    """Self-contained agent: act / observe / train-tick / save / load."""

    def __init__(self, cfg: DQNConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.params = init_qnet(cfg, seed)
        self.target = copy.deepcopy(self.params)
        self.opt = torch.optim.SGD(self.params.parameters(), lr=cfg.lr,
                                   momentum=0.9, dampening=0.0)
        self.replay = Replay(cfg)
        self.update = make_td_update(cfg)
        self.steps = 0
        self.losses: list = []

    def epsilon(self) -> float:
        c = self.cfg
        frac = min(1.0, self.steps / max(c.eps_decay_steps, 1))
        return c.eps_start + (c.eps_end - c.eps_start) * frac

    def act(self, obs: np.ndarray, explore: bool = True,
            eps: Optional[float] = None) -> np.ndarray:
        """Returns per-stage choice indices (r,) in 0..4. `eps` raises the
        exploration floor above the schedule (tuning-window exploration)."""
        e = self.epsilon() if eps is None else max(eps, self.epsilon())
        if explore and self.rng.rand() < e:
            return self.rng.randint(0, N_CHOICES, size=self.cfg.n_stages)
        return greedy_action(self.params, obs.astype(np.float32), self.cfg)

    def observe(self, obs, act, rew, nobs, done):
        self.replay.add(obs, act, rew, nobs, float(done))
        self.steps += 1
        if len(self.replay) >= self.cfg.batch_size:
            batch = self.replay.sample(self.rng, self.cfg.batch_size)
            self.losses.append(self.update(self.params, self.target,
                                           self.opt, *batch))
        if self.steps % self.cfg.target_update == 0:
            self.target.load_state_dict(self.params.state_dict())

    # ------------------------------------------------------ persistence ---
    def state_dict(self) -> dict:
        return {"qnet": qnet_to_numpy(self.params), "steps": self.steps,
                "cfg": dataclasses.asdict(self.cfg)}

    def load_state_dict(self, state: dict):
        self.params.load_state_dict(qnet_from_numpy(state["qnet"]))
        self.target.load_state_dict(self.params.state_dict())
        self.steps = int(state.get("steps", 0))
