"""InTune controller: the drop-in wrapper (paper §4.4, Listing 1).

    # the unified driver (repro_torch.api): any backend, one loop
    backend = ExecutorBackend.wrap(pipe)      # or SimBackend(spec, machine)
    Session(backend, InTune(spec, machine)).run(ticks)
    # the closed training loop: a train loop drives the Session
    session = Session(FeedBackend(pipe, feed), InTune(spec, machine))
    session.step()                            # between train steps
    # legacy live mode (tunes a real executor in-process):
    tuner.attach(pipe); tuner.live_tick()
    # legacy self-driving paper protocol (ControllerBackend wraps this):
    for _ in range(ticks):
        tuner.tick()

One controller instance runs per trainer host; its state (agent weights,
replay, current allocation) serializes into train/checkpoint.py extras so
a restarted job resumes pipeline tuning where it left off.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from repro_torch.core import actions as act_lib
from repro_torch.core.agent import DQNAgent, DQNConfig
from repro_torch.core.env import PipelineEnv
from repro_torch.data.pipeline import PipelineSpec
from repro_torch.data.simulator import Allocation, MachineSpec

if TYPE_CHECKING:   # annotation-only: keep the core plane below repro.api
    from repro_torch.api.telemetry import Telemetry


class InTune:
    """RL data-pipeline optimizer with online fine-tuning.

    Speaks the Optimizer protocol (repro.core.optimizer): drivers loop
    propose -> apply -> observe, with the driver owning the authoritative
    simulator or executor. The internal PipelineEnv then serves purely as
    the observation/reward builder. The legacy self-driving tick() loop
    (this env's own simulator is authoritative) remains for pretraining
    and the paper-protocol benchmarks.
    """

    name = "intune"

    def __init__(self, spec: PipelineSpec, machine: MachineSpec,
                 model_latency: float = 0.0, seed: int = 0,
                 head: str = "joint",
                 pretrained: Optional[dict] = None,
                 explore: bool = True,
                 finetune_ticks: int = 300,
                 track_best: bool = True,
                 explore_restart_every: int = 25,
                 finetune_eps: Optional[float] = 0.4,
                 init_alloc: Optional[Allocation] = None,
                 lcb_coef: float = 0.0,
                 switch_margin: float = 0.0,
                 stale_scale: float = 1.0,
                 readapt_stale_s: float = 10.0,
                 readapt_drift: float = 0.5):
        self.spec = spec
        self.env = PipelineEnv(spec, machine, model_latency, seed=seed)
        if init_alloc is not None:
            # where the exploration walk starts. The env defaults to
            # heuristic_even (use the whole machine) — right for a
            # dedicated preprocessing host, wrong at a feed boundary on
            # a shared host, where the conservative launch placement is
            # minimal workers scaled up only as measurements justify.
            self.env.set_allocation(init_alloc)
        # protocol path: hold the FIRST proposal at the launch
        # allocation so it gets measured before any move — the action
        # space allows multi-worker jumps, so an immediate move would
        # leave the launch placement (often the true optimum at a feed
        # boundary) permanently absent from the incumbent statistics.
        self._hold_first = init_alloc is not None
        cfg = DQNConfig(obs_dim=self.env.obs_dim, n_stages=spec.n_stages,
                        head=head)
        self.agent = DQNAgent(cfg, seed=seed)
        if pretrained is not None:
            self.agent.load_state_dict(pretrained)
            # pretrained agents fine-tune online at the floor epsilon
            self.agent.steps = max(self.agent.steps, cfg.eps_decay_steps)
        self.explore = explore
        # two-phase behavior (paper: "achieves a stable throughput rate
        # within about 10 minutes"): explore/fine-tune for finetune_ticks,
        # then serve greedily; a resize re-opens an exploration window.
        self.finetune_ticks = finetune_ticks
        self.ticks_since_reset = 0
        self.track_best = track_best
        # Optimizer-protocol path only: every N window ticks, restart the
        # epsilon-greedy walk from the incumbent best allocation, so
        # exploration concentrates around the best basin found instead of
        # drifting (matters once the action space is 5^r for larger DAGs).
        # The legacy tick() loop ignores this and keeps the paper protocol.
        self.explore_restart_every = explore_restart_every
        # protocol path only: exploration floor inside the tuning window
        # (the schedule's floor applies outside / when None)
        self.finetune_eps = finetune_eps
        self.best: tuple = (-1.0, None)  # (score, allocation)
        # protocol path only: per-allocation reward statistics. Live
        # windows are NOISY (a couple of train steps of wall clock), so
        # the incumbent is the argmax of a visit-count-penalized running
        # MEAN, not of any single window — one lucky window must not
        # lock a bad allocation in as the serving choice.
        self._alloc_stats: dict = {}   # key -> (visits, mean_reward)
        # how aggressively _track_best distrusts sparsely-visited
        # allocations (confidence penalty lcb_coef/sqrt(visits)) and how
        # much better a challenger must score to dethrone the incumbent.
        # Zero both on a low-noise backend (the simulator): there a
        # single reading IS the allocation's value and any stickiness
        # just slows convergence. Raise them on live process backends
        # where a window is a couple of train steps of noisy wall clock
        # (benchmarks/fig_train_feed.py uses 0.15 / 0.05 on rewards
        # in [0, 1]).
        self.lcb_coef = lcb_coef
        self.switch_margin = switch_margin
        # streaming: freshness folds into the reward through
        # staleness AGING — the per-window GROWTH of batch staleness —
        # as 1/(1 + aging/stale_scale). Growth, not the absolute level:
        # absolute staleness is a function of how long the overload has
        # lasted, so it would score the same allocation differently at
        # minute 1 and minute 5 of a spike and corrupt the incumbent
        # statistics. Aging is stationary: an allocation that drains
        # backlog ages 0 regardless of when it is visited, one that
        # falls behind ages at its (fixed) shortfall rate. In a trough
        # every keeping-up allocation ages 0 and the (1 - mem_frac)
        # factor makes shedding workers pay.
        # A serving-mode incumbent is DETHRONED (exploration reopens,
        # incumbent stats cleared) when absolute staleness sits above
        # readapt_stale_s without improving since serving began, or
        # measured throughput drifts DOWN by more than readapt_drift of
        # its serving-time EWMA: the traffic the incumbent was crowned
        # under no longer exists, so its statistics are stale too.
        # 0 disables either trigger (see _stream_readapt).
        self.stale_scale = stale_scale
        self.readapt_stale_s = readapt_stale_s
        self.readapt_drift = readapt_drift
        self._prev_stale = 0.0
        self._serve_stale0 = float("inf")
        self._tput_ref: Optional[float] = None
        self.obs = self.env.observe()
        self.history: list[dict] = []

    # --------------------------------------------------------- tuning -----
    def tick(self) -> dict:
        """One observe -> act -> apply -> learn cycle."""
        exploring = self.explore and \
            self.ticks_since_reset < self.finetune_ticks
        choices = self.agent.act(self.obs, explore=exploring)
        nobs, reward, metrics = self.env.step(choices)
        self.agent.observe(self.obs, choices, reward, nobs, done=False)
        self.obs = nobs
        self.ticks_since_reset += 1
        if self.track_best and reward > self.best[0]:
            self.best = (reward, self.env.alloc.copy())
        # at the end of the tuning window, snap back to the best allocation
        # seen (the tuner keeps learning greedily from there)
        if self.ticks_since_reset == self.finetune_ticks \
                and self.best[1] is not None:
            self.env.set_allocation(self.best[1])
            self.obs = self.env.observe()
        rec = dict(metrics)
        rec["reward"] = reward
        rec["workers"] = self.env.alloc.workers.copy()
        rec["prefetch_mb"] = self.env.alloc.prefetch_mb
        self.history.append(rec)
        return rec

    def run(self, ticks: int) -> list:
        return [self.tick() for _ in range(ticks)]

    def resize(self, n_cpus: int):
        """Machine resize: no relaunch needed — the free-CPU observation
        shifts and the agent re-allocates (the paper's Fig. 5C behavior).
        Re-opens the exploration window so the agent can work the new
        resource pool."""
        self.env.resize(n_cpus)
        self.ticks_since_reset = 0
        self.best = (-1.0, None)
        self._alloc_stats = {}

    @property
    def allocation(self) -> Allocation:
        return self.env.alloc

    # ------------------------------------------------- Optimizer protocol --
    def propose(self, spec: PipelineSpec = None, machine: MachineSpec = None,
                stats: dict = None) -> Allocation:
        """One incremental allocation move from the current observation.

        `stats`, when given, is a live stats() dict (executor contract) and
        replaces the simulator-built observation. A machine with a
        different CPU count re-opens the exploration window (resize).
        """
        if spec is not None and spec != self.spec:
            raise ValueError(
                f"InTune was built for spec {self.spec.name!r}; rebuild "
                f"the controller to tune {spec.name!r}")
        if machine is not None \
                and machine.n_cpus != self.env.sim.machine.n_cpus:
            self.resize(machine.n_cpus)
        if stats is not None:
            self.obs = self._live_obs(stats)
        if self._hold_first:
            # measure the launch allocation itself before moving
            self._hold_first = False
            self._pending = (self.obs, None)
            return self.env.alloc
        exploring = self.explore and \
            self.ticks_since_reset < self.finetune_ticks
        if not exploring and self.track_best and self.best[1] is not None:
            # serving mode: hold the incumbent best (stable throughput, the
            # paper's post-tuning behavior); a resize reopens exploration.
            # Still pend the observation (choices=None, no agent update):
            # serving windows keep refining the incumbent's reward mean,
            # so an incumbent crowned by a lucky window is dethroned by
            # its own serving measurements instead of held forever.
            self.env.alloc = self.best[1].copy()
            self._pending = (self.obs, None)
            return self.env.alloc
        choices = self.agent.act(self.obs, explore=exploring,
                                 eps=self.finetune_eps if exploring
                                 else None)
        workers, pf = act_lib.next_allocation(
            choices, self.env.alloc.workers, self.env.alloc.prefetch_mb,
            prefetch_idx=self.env.prefetch_idx,
            max_workers=self.env.sim.machine.n_cpus)
        self.env.alloc = Allocation(workers, pf)
        self._pending = (self.obs, choices)
        return self.env.alloc

    def observe(self, metrics: Telemetry) -> None:
        """Learn from the telemetry of the proposal the driver just
        applied.

        `metrics` is the backend's Telemetry (or, legacy, a simulator tick
        dict with mem_mb/throughput, or a live executor stats() dict with
        stage_latency/mem_frac/... — Telemetry is mapping-compatible so
        all three read identically). Live drivers pass stats to BOTH
        propose and observe, so the transition's next-state comes from the
        same measurement source as the state the agent acted on — never
        from the internal analytic env.
        """
        if getattr(self, "_pending", None) is None:
            return
        pobs, choices = self._pending
        self._pending = None
        if "stage_latency" in metrics:      # live stats() contract
            mem_frac = min(metrics["mem_frac"], 1.0)
            nobs = self._live_obs(metrics)
        else:
            mem_frac = min(
                metrics["mem_mb"] / self.env.sim.machine.mem_mb, 1.0)
            nobs = self.env.observe()
        idle = metrics.get("device_idle_frac") \
            if hasattr(metrics, "get") else None
        stale = metrics.get("batch_staleness_s") \
            if hasattr(metrics, "get") else None
        if idle is not None:
            # feed-boundary telemetry (FeedBackend): the objective IS
            # keeping the device busy. Pipe throughput would be the
            # WRONG reward here — on a shared host more pipeline
            # workers raise pipe throughput by stealing the trainer's
            # cores, which is exactly what device_idle_frac charges for.
            reward = (1.0 - idle) * (1 - mem_frac)
        elif stale is not None:
            # streaming telemetry: throughput alone can't distinguish
            # "keeping up" from "an arrival trough" — the freshness
            # factor charges for staleness GROWTH this window (see
            # __init__: growth is stationary across a spike, the
            # absolute level is not), so an allocation falling behind
            # scores low even while its throughput looks fine, and in
            # a trough the highest reward goes to the leanest
            # allocation that stays fresh (shed workers, save memory).
            aging = max(0.0, float(stale) - self._prev_stale)
            self._prev_stale = float(stale)
            fresh = 1.0 / (1.0 + aging / self.stale_scale)
            reward = (metrics["throughput"] / self.env.reward_scale) \
                * (1 - mem_frac) * fresh
        else:
            reward = (metrics["throughput"] / self.env.reward_scale) \
                * (1 - mem_frac)
        if choices is not None:
            self.agent.observe(pobs, choices, reward, nobs, done=False)
        self.obs = nobs
        self.ticks_since_reset += 1
        if self.track_best:
            self._track_best(reward)
        # record the allocation that actually produced this tick's metrics,
        # before any snap below replaces it
        rec = dict(metrics)
        rec["reward"] = reward
        rec["workers"] = self.env.alloc.workers.copy()
        rec["prefetch_mb"] = self.env.alloc.prefetch_mb
        self.history.append(rec)
        # end of the tuning window — or an exploration restart inside it —
        # snaps to the best allocation seen (no sim.apply here: the
        # driver's simulator is the authoritative one)
        at_window_end = self.ticks_since_reset == self.finetune_ticks
        at_restart = (self.explore_restart_every > 0
                      and self.ticks_since_reset < self.finetune_ticks
                      and self.ticks_since_reset
                      % self.explore_restart_every == 0)
        if (at_window_end or at_restart) and self.best[1] is not None:
            self.env.alloc = self.best[1].copy()
            if "stage_latency" not in metrics:
                # sim mode only: rebuild the observation for the snapped
                # allocation. In live mode the next propose(stats=...)
                # supplies the real observation — never fabricate one.
                self.obs = self.env.observe()
        if stale is not None:
            self._stream_readapt(float(stale), float(metrics["throughput"]))

    def _stream_readapt(self, stale: float, tput: float) -> None:
        """Serving-mode re-adaptation triggers for streaming graphs: the
        incumbent was crowned under the traffic of its tuning window, so
        when staleness crosses the scale (backlog building — a spike the
        incumbent can't drain) or throughput drifts DOWN from its
        serving-time EWMA (a trough leaving workers idle), reopen
        exploration exactly as a machine resize does. Upward drift is
        deliberately NOT a trigger: throughput rising while freshness
        holds means a demand surge is being served — reopening would
        trade a working allocation for an exploration storm on a loaded
        host, and the surge the incumbent CANNOT serve is exactly what
        the staleness trigger catches. The staleness trigger is level-based with a
        progress guard: reopen only when staleness is over the line AND
        has not improved since serving began. The guard separates the
        two ways to be stale: an incumbent draining a spike's backlog at
        full rate is making progress and must be left alone, while one
        whose capacity is below the arrival rate shows no improvement
        and gets retried after every failed serving stretch (the
        exploration window is the refractory period). An edge trigger
        here is a trap: if one reopening crowns a bad incumbent,
        staleness never re-crosses (it never fell) and the controller
        serves that bad incumbent for the rest of the overload."""
        serving = self.ticks_since_reset >= self.finetune_ticks
        if self.ticks_since_reset == self.finetune_ticks:
            self._serve_stale0 = stale
        crossed = (self.ticks_since_reset > self.finetune_ticks
                   and self.readapt_stale_s > 0
                   and stale > self.readapt_stale_s
                   and stale >= self._serve_stale0)
        drift = False
        if self._tput_ref is None:
            self._tput_ref = tput
        else:
            if serving and self.readapt_drift > 0 and self._tput_ref > 1e-9 \
                    and (self._tput_ref - tput) \
                    > self.readapt_drift * self._tput_ref:
                drift = True
            self._tput_ref += 0.2 * (tput - self._tput_ref)
        if serving and (crossed or drift):
            self.ticks_since_reset = 0
            self.best = (-1.0, None)
            self._alloc_stats = {}
            self._tput_ref = None
            self._serve_stale0 = float("inf")

    def _track_best(self, reward: float) -> None:
        """Update the incumbent from a measured window (protocol path).

        Each allocation's reward estimate is a running mean over its
        visits, scored with a 1/sqrt(visits) confidence penalty. The
        exploration walk restarts from the incumbent, so good basins
        accumulate visits and shed their penalty while a one-off lucky
        window keeps most of its discount — the single-max rule this
        replaces let such windows permanently capture the serving slot.
        (The legacy tick() path keeps single-max: its analytic simulator
        is deterministic, so windows are noise-free there.)
        """
        key = (tuple(int(w) for w in self.env.alloc.workers),
               float(self.env.alloc.prefetch_mb))
        n, mu = self._alloc_stats.get(key, (0, 0.0))
        n += 1
        mu += (reward - mu) / n
        self._alloc_stats[key] = (n, mu)

        def score(vn, vmu):
            return vmu - self.lcb_coef / np.sqrt(vn)

        if self.best[1] is not None:
            # refresh the incumbent's score from its own latest stats —
            # serving windows re-measure it, so a lucky crowning decays
            # toward the allocation's true mean
            bkey = (tuple(int(w) for w in self.best[1].workers),
                    float(self.best[1].prefetch_mb))
            if bkey in self._alloc_stats:
                bn, bmu = self._alloc_stats[bkey]
                self.best = (score(bn, bmu), self.best[1])
        ckey, (cn, cmu) = max(
            self._alloc_stats.items(),
            key=lambda kv: score(kv[1][0], kv[1][1]))
        # hysteresis: dethroning costs a live worker-pool resize whose
        # first window reads artificially bad, so near-ties must not
        # flip the serving choice back and forth — a challenger needs a
        # clear margin, not a coin-toss win
        if self.best[1] is None \
                or score(cn, cmu) > self.best[0] + self.switch_margin:
            self.best = (score(cn, cmu),
                         Allocation(np.array(ckey[0], dtype=int), ckey[1]))

    # ----------------------------------------------------- live executor --
    def attach(self, executor, interval_s: float = 1.0):
        """Tune a real ThreadedPipeline: each tick reads its rate meters,
        applies the chosen allocation to the worker pools."""
        self._executor = executor
        self._interval = interval_s

    def live_tick(self):
        ex = self._executor
        stats = ex.stats()
        choices = self.agent.act(self.obs, explore=self.explore)
        workers, pf = act_lib.next_allocation(
            choices, np.array(ex.worker_counts(), dtype=int),
            ex.prefetch_mb, prefetch_idx=self.env.prefetch_idx,
            max_workers=self.env.sim.machine.n_cpus)
        ex.set_allocation(workers, pf)
        reward = stats["throughput"] / self.env.reward_scale \
            * (1 - min(stats["mem_frac"], 1.0))
        nobs = self._live_obs(stats)
        self.agent.observe(self.obs, choices, reward, nobs, done=False)
        self.obs = nobs
        return stats

    def _live_obs(self, stats) -> np.ndarray:
        m = self.env.sim.machine
        lat = np.asarray(stats["stage_latency"], np.float32)
        lat = lat / (lat.mean() + 1e-9)
        workers = np.asarray(stats["workers"], np.float32) / 128.0
        return np.concatenate([
            lat, workers,
            [stats.get("prefetch_mb", 0.0) / m.mem_mb,
             stats["free_cpus"] / 128.0, 1.0 - stats["mem_frac"],
             self.env.sim.model_latency, m.dram_bw_gbps / 100.0,
             m.cpu_ghz / 4.0]]).astype(np.float32)

    # ------------------------------------------------------- persistence --
    def state_dict(self) -> dict:
        return {"agent": self.agent.state_dict(),
                "workers": self.env.alloc.workers.tolist(),
                "prefetch_mb": float(self.env.alloc.prefetch_mb)}

    def load_state_dict(self, state: dict):
        self.agent.load_state_dict(state["agent"])
        self.env.set_allocation(Allocation(
            np.array(state["workers"], dtype=int),
            float(state["prefetch_mb"])))
        self.obs = self.env.observe()
