"""LiveFleet: the fleet plane on real ThreadedPipeline executors.

FleetSim (data/fleet.py) validates fleet policies against N analytic
per-trainer models; this module is the same plane made executable — one
real `ThreadedPipeline` per active trainer, with worker threads whose
per-item work realizes each StageSpec's true cost, and a consumer thread
per trainer modeling the training loop (pulls batches, sleeps
`model_latency` per batch, so model demand back-pressures the pipeline
exactly where the simulator caps throughput).

LiveFleet speaks the exact FleetSim driver dialect (`machine` / `apply`
/ `resize` / `oom_count`), so `repro.api.Session` and the
`FleetCoordinator` drive it unchanged. Contract alignment with the sim:

  - THROUGHPUT is measured, not modeled: `apply` sets every active
    trainer's allocation first (atomically, before any measurement),
    then sleeps one shared `window_s` window and reads each pipeline's
    batch-counter delta over the measured elapsed
    (`ThreadedPipeline.counters`, wall-clock-free of the EWMA meters).
  - MEMORY is budget-enforced accounting: the same `graph_memory_mb`
    model the simulator scores OOMs with. An over-budget allocation is
    an OOM — the pipeline process is killed (hard stop, no drain) and
    pays the simulator's `OOM_RESTART_TICKS` dead window before a fresh
    relaunch — so the coordinator's admission control and quarantine
    semantics transfer verbatim.
  - CHURN honors the soft/hard stop split: a `leave` (and `close`) tears
    a pipeline down gracefully — soft-stop, drain the output queue, then
    hard-stop and join every thread — and accounts any sink-delivered
    batch that was lost in `dropped_batches` (0 on clean teardown). A
    `join` spins up a fresh pipeline; `resize`/`pool` re-caps apply
    before the next measurement window.

Known sim-vs-live gaps (DESIGN.md §7): stage work is `time.sleep`, so a
serial fraction is emulated by a per-stage lock (exact only for
`serial_frac == 0`, which the live clusters below use), and CPU
over-subscription does not physically contend — the simulator's
proportional slowdown is charged in accounting instead. The process
plane (repro.data.proc_executor, DESIGN.md §9) closes both gaps with
real CPU burns; this module also hosts the `RigSlot` lifecycle and
`_TrainerRig` consumer rig that plane reuses.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.data.executor import ThreadedPipeline
from repro_torch.data.fleet import (ClusterSpec, FleetAllocation, FleetBackend,
                                    TrainerSpec, churn_schedule)
from repro_torch.data.pipeline import StageGraph, StageSpec
from repro_torch.data.simulator import (Allocation, MachineSpec,
                                        OOM_RESTART_TICKS, graph_memory_mb)


def synthetic_stage_fns(spec: StageGraph) -> Dict[str, Callable]:
    """Work functions realizing each StageSpec's true cost with sleeps.

    A stage's fn takes `cost` seconds per item, so with `w` workers it
    sustains `w / cost` batches/s — exactly the simulator's service rate
    when `serial_frac == 0`. A non-zero serial fraction is emulated by
    taking `serial_frac * cost` under a per-stage lock (an approximation
    of Amdahl scaling: both saturate at `1 / (serial_frac * cost)`, but
    the knee differs — live differential clusters use 0).

    Sources emit an infinite stream (training never hits EOS); joins
    pair one item per input; everything else forwards its input.
    """
    fns: Dict[str, Callable] = {}
    for st in spec.stages:
        serial = st.serial_frac * st.cost
        par = st.cost - serial
        lock = threading.Lock() if serial > 1e-9 else None

        def work(lock=lock, serial=serial, par=par):
            if lock is not None:
                with lock:
                    time.sleep(serial)
            if par > 0:
                time.sleep(par)

        if not st.inputs:
            def fn(work=work):
                work()
                return 1                       # infinite stream, never EOS
        elif len(st.inputs) > 1:
            def fn(*items, work=work):
                work()
                return items
        else:
            def fn(item, work=work):
                work()
                return item
        fns[st.name] = fn
    return fns


class _TrainerRig:
    """One live trainer: a pipeline plus a consumer thread that models
    the training loop — it pulls batches and sleeps `model_latency` per
    batch, so a saturated model back-pressures the pipeline through the
    (prefetch-bounded) output queue, the live realization of the
    simulator's `1 / model_latency` throughput cap.

    `make_pipe(trainer, eff_cpus, queue_depth)` picks the execution
    substrate; the default builds a sleep-based ThreadedPipeline (the
    process plane passes a ProcessPipeline factory instead)."""

    def __init__(self, trainer: TrainerSpec, eff_cpus: int,
                 queue_depth: int = 8, make_pipe=None):
        self.trainer = trainer
        if make_pipe is None:
            self.pipe = ThreadedPipeline(
                trainer.pipeline, fns=synthetic_stage_fns(trainer.pipeline),
                queue_depth=queue_depth,
                machine=dataclasses.replace(trainer.machine,
                                            n_cpus=int(eff_cpus)))
        else:
            self.pipe = make_pipe(trainer, int(eff_cpus), queue_depth)
        self._stop = threading.Event()
        self._consumer = threading.Thread(target=self._model_loop,
                                          daemon=True)
        self._consumer.start()

    def _model_loop(self):
        while not self._stop.is_set():
            try:
                self.pipe.get_batch(timeout=0.05)
            except (queue.Empty, StopIteration):
                continue
            if self.trainer.model_latency > 0:
                time.sleep(self.trainer.model_latency)

    # ---------------------------------------------------------- control ---
    def set_allocation(self, alloc: Allocation):
        self.pipe.set_allocation(alloc.workers, alloc.prefetch_mb)

    def set_eff_cpus(self, n: int):
        self.pipe.machine = dataclasses.replace(self.pipe.machine,
                                                n_cpus=int(n))
        if hasattr(self.pipe, "apply_cpu_cap"):
            self.pipe.apply_cpu_cap()      # process plane: re-pin workers

    def counters(self) -> dict:
        return self.pipe.counters()

    def teardown(self, drain: bool = True, timeout: float = 5.0) -> dict:
        """Stop the consumer first (so the drain accounting is stable),
        then shut the pipeline down. drain=True is the clean leave path;
        drain=False models an OOM kill."""
        self._stop.set()
        self._consumer.join(timeout=timeout)
        acct = self.pipe.shutdown(drain=drain, timeout=timeout)
        acct["joined"] = acct["joined"] and not self._consumer.is_alive()
        return acct


class RigSlot:
    """One live trainer's kill / dead-window / relaunch lifecycle.

    ExecutorBackend (single machine), LiveFleet (one slot per trainer),
    and ProcessBackend all used to hand-roll the same tick: count a
    restart window down and relaunch when it expires, hard-kill on the
    OOM judge's verdict (no drain — an OOM is a crash), accumulate
    crash-lost batches and the thread-leak flag. This class is that
    tick, extracted so the paths cannot drift (both sites stay pinned by
    the executor-parity and live-fleet tests).

    `launch(eff_cpus) -> rig` builds a fresh rig; `rig` is anything with
    the _TrainerRig surface (pipe / set_allocation / set_eff_cpus /
    counters / teardown).
    """

    def __init__(self, launch, rig=None):
        self.launch = launch
        self.rig = rig
        self.restart_left = 0
        self.oom_count = 0
        self.crash_lost = 0
        self.all_joined = True
        # stream epoch carried across an OOM relaunch (proc plane): the
        # arrival curve survives the crash — see kill()/tick_dead_window
        self.carry_epoch = None

    @property
    def live(self) -> bool:
        return self.rig is not None

    def tick_dead_window(self, eff_cpus: int) -> bool:
        """True while this tick falls inside the dead window: counts it
        down and relaunches a fresh rig the moment it expires (the
        simulator's OOM_RESTART_TICKS protocol, verbatim)."""
        if self.restart_left <= 0:
            return False
        self.restart_left -= 1
        if self.restart_left == 0 and self.rig is None:
            self.rig = self.launch(eff_cpus)
            if self.carry_epoch is not None:
                # resume the predecessor's arrival curve: stream time ran
                # on through the dead window, so the relaunched source
                # faces the backlog that accrued while it was down —
                # exactly the simulator's backlog-OOM crash-loop dynamics
                adopt = getattr(self.rig.pipe, "adopt_stream_epoch", None)
                if callable(adopt):
                    adopt(self.carry_epoch)
                self.carry_epoch = None
        return True

    def kill(self):
        """The OOM judge's verdict: the process is killed — hard stop,
        no drain — and pays the restart window before relaunch."""
        self.oom_count += 1
        self.restart_left = OOM_RESTART_TICKS
        if self.rig is not None:
            epoch = getattr(self.rig.pipe, "stream_epoch", None)
            if callable(epoch):
                self.carry_epoch = epoch()
            acct = self.rig.teardown(drain=False)
            self.crash_lost += max(0, acct["delivered"] - acct["consumed"])
            self.all_joined = self.all_joined and acct["joined"]
            self.rig = None

    def prepare(self, eff_cpus: int, alloc: Allocation):
        """Sync the rig's CPU cap and apply the allocation — called for
        every measuring trainer BEFORE any measurement window opens."""
        if self.rig.pipe.machine.n_cpus != eff_cpus:
            self.rig.set_eff_cpus(eff_cpus)
        self.rig.set_allocation(alloc)

    @staticmethod
    def discount(tput: float, used: int, eff: int) -> float:
        """Sleep-based rigs can't physically contend, so the simulator's
        proportional over-subscription slowdown is charged in
        accounting. The process plane must NOT call this — its
        contention is real and already in the measured rate."""
        return tput * (eff / used) if used > eff else tput

    def close(self, drain: bool = True) -> int:
        """Clean teardown (leave / shutdown); returns dropped batches.
        A clean leave forfeits any carried stream epoch — only the OOM
        kill/relaunch path resumes the curve; an explicit rejoin is a
        fresh stream."""
        self.carry_epoch = None
        dropped = 0
        if self.rig is not None:
            acct = self.rig.teardown(drain=drain)
            dropped = acct["dropped"]
            self.all_joined = self.all_joined and acct["joined"]
            self.rig = None
        return dropped


class LiveFleet(FleetBackend):
    """Drop-in fleet backend: one real ThreadedPipeline per active
    trainer, FleetSim's exact driver dialect.

    `seed` is accepted for factory-signature compatibility with FleetSim
    (thread scheduling is the noise source here, not an RNG).
    `window_s` is the per-tick measurement window; throughput is the
    consumed-batch counter delta over the measured elapsed. Call
    `close()` (or use as a context manager) to tear every rig down and
    collect the final drop/leak accounting.
    """

    def __init__(self, cluster: ClusterSpec, seed: int = 0,
                 window_s: float = 0.1, queue_depth: int = 8):
        super().__init__(cluster)
        self.window_s = float(window_s)
        self.queue_depth = queue_depth
        self.dropped_batches = 0
        self._closed = False
        self.slots: Dict[str, RigSlot] = {
            t.name: RigSlot(self._make_launch(t)) for t in cluster.trainers}
        for t in cluster.trainers:
            if t.start_active:
                self.slots[t.name].rig = self.slots[t.name].launch(
                    t.machine.n_cpus)

    def _make_launch(self, trainer: TrainerSpec):
        return lambda eff: _TrainerRig(trainer, eff, self.queue_depth)

    # ------------------------------------------------- legacy dict views --
    @property
    def rigs(self) -> Dict[str, _TrainerRig]:
        """Live rigs by trainer name (membership = the process is up)."""
        return {n: s.rig for n, s in self.slots.items() if s.rig is not None}

    @property
    def oom_counts(self) -> Dict[str, int]:
        return {n: s.oom_count for n, s in self.slots.items()}

    @property
    def restart_left(self) -> Dict[str, int]:
        return {n: s.restart_left for n, s in self.slots.items()}

    @property
    def crash_lost(self) -> int:
        return sum(s.crash_lost for s in self.slots.values())

    @property
    def all_joined(self) -> bool:
        return all(s.all_joined for s in self.slots.values())

    # ----------------------------------------------------------- churn ----
    def _on_join(self, name: str):
        slot = self.slots[name]
        # a (re)joining machine is a fresh process: no restart debt, and
        # no stream epoch carried over (an explicit rejoin starts fresh)
        slot.restart_left = 0
        slot.carry_epoch = None
        if slot.rig is None:
            slot.rig = slot.launch(self._base[name])

    def _on_leave(self, name: str):
        self.dropped_batches += self.slots[name].close(drain=True)

    @property
    def oom_count(self) -> int:
        return sum(s.oom_count for s in self.slots.values())

    # -------------------------------------------- substrate judge hooks ----
    # The threaded plane enforces the simulator's BUDGET memory model
    # before the window opens and charges the accounting discount for
    # over-subscription (sleeps don't contend); the process plane
    # (ProcFleet) swaps all three hooks for physics — measured RSS after
    # the window, no discount.
    def _pre_window_oom(self, trainer: TrainerSpec, slot: RigSlot,
                        mem: float) -> bool:
        """Budget-enforced OOM (the simulator's judge, verbatim): kill +
        OOM_RESTART_TICKS dead window, via the shared RigSlot
        lifecycle."""
        return mem > trainer.machine.mem_mb

    def _post_window_judge(self, trainer: TrainerSpec, slot: RigSlot,
                           mem: float) -> Tuple[float, bool]:
        """Post-measurement memory verdict: (reported mem_mb, killed).
        Budget accounting already judged pre-window, so this is a
        no-op here; ProcFleet samples measured RSS instead."""
        return mem, False

    def _discount(self, tput: float, used: int, eff: int) -> float:
        """Sleeps don't contend like real CPUs: charge the sim's
        proportional over-subscription slowdown in accounting."""
        return RigSlot.discount(tput, used, eff)

    # ------------------------------------------------------------ tick ----
    def apply(self, falloc: FleetAllocation) -> dict:
        self._advance_events()
        state = self.machine
        self._check_falloc(falloc, state)
        per: Dict[str, dict] = {}
        measuring: List[tuple] = []
        for name in state.active:
            trainer = self.cluster.trainer(name)
            eff = self._base[name] + int(falloc.grants.get(name, 0))
            if name not in falloc.allocs:
                raise KeyError(
                    f"no allocation proposed for active trainer {name!r}")
            alloc = falloc.allocs[name]
            mem = graph_memory_mb(trainer.pipeline, alloc.workers,
                                  alloc.prefetch_mb)
            used = int(np.sum(alloc.workers))
            slot = self.slots[name]
            if slot.tick_dead_window(eff):
                per[name] = {"throughput": 0.0, "mem_mb": mem, "oom": False,
                             "restarting": True, "used_cpus": used,
                             "eff_cpus": eff}
                continue
            if self._pre_window_oom(trainer, slot, mem):
                slot.kill()
                per[name] = {"throughput": 0.0, "mem_mb": mem, "oom": True,
                             "restarting": True, "used_cpus": used,
                             "eff_cpus": eff}
                continue
            slot.prepare(eff, alloc)
            measuring.append((name, trainer, slot, mem, used, eff))
        # one shared measurement window: every allocation above is applied
        # BEFORE any trainer is measured, so pool re-caps and grant moves
        # land atomically across the fleet
        before = {name: slot.rig.counters()
                  for name, _, slot, *_ in measuring}
        if measuring:
            time.sleep(self.window_s)
        for name, trainer, slot, mem, used, eff in measuring:
            after = slot.rig.counters()
            tput = ThreadedPipeline.window_rate(before[name], after)
            mem, killed = self._post_window_judge(trainer, slot, mem)
            if killed:
                per[name] = {"throughput": 0.0, "mem_mb": mem, "oom": True,
                             "restarting": True, "used_cpus": used,
                             "eff_cpus": eff}
                continue
            tput = self._discount(tput, used, eff)
            per[name] = {"throughput": tput, "mem_mb": mem, "oom": False,
                         "restarting": False, "used_cpus": used,
                         "eff_cpus": eff}
        self.time += 1
        tput = sum(m["throughput"] for m in per.values())
        mem = sum(m["mem_mb"] for m in per.values())
        used = sum(min(m["used_cpus"], m["eff_cpus"]) for m in per.values())
        return {"throughput": tput, "mem_mb": mem, "used_cpus": int(used),
                "oom": any(m["oom"] for m in per.values()),
                "restarting": any(m["restarting"] for m in per.values()),
                "n_active": len(state.active), "pool": self.pool,
                "per_trainer": per}

    # -------------------------------------------------------- teardown ----
    def close(self) -> dict:
        """Tear down every live rig; returns the final accounting the
        churn soak test asserts on: clean-teardown batch drops, OOM-crash
        losses, and whether every thread ever started was joined."""
        if not self._closed:
            self._closed = True
            for slot in self.slots.values():
                self.dropped_batches += slot.close(drain=True)
            self._acct = {"dropped_batches": self.dropped_batches,
                          "crash_lost": self.crash_lost,
                          "all_joined": self.all_joined,
                          "oom_count": self.oom_count}
        return self._acct

    def __enter__(self) -> "LiveFleet":
        return self

    def __exit__(self, *exc):
        self.close()


class ProcFleet(LiveFleet):
    """The fleet plane on REAL OS processes: one ProcessPipeline per
    active trainer via the `_TrainerRig(make_pipe=...)` hook, so every
    trainer in the fleet runs real CPU-contended burns.

    Everything LiveFleet charges in accounting is physics here, exactly
    as ProcessBackend vs ExecutorBackend on the single-machine plane:

      - NO over-subscription discount: workers across ALL trainers
        contend for the same host cores, so over-placing slows the
        measured rate because silicon actually runs out;
      - MEMORY is measured, not budgeted: after the shared window each
        trainer's OOM verdict comes from its pipeline's sampled resident
        bytes (`rss_mb()`, growth since spawn) against its machine's
        `mem_mb` — then the same kill + OOM_RESTART_TICKS + relaunch
        lifecycle as every other plane (the shared RigSlot);
      - a stream trainer's arrival curve SURVIVES the OOM: RigSlot
        carries `stream_epoch()` across the kill, so the relaunch
        resumes (backlog accrued while dead), matching the sim.

    `ballast=False` skips the per-worker memory ballast (cheap CI rigs);
    leave it True when the RSS OOM judge is under test.
    """

    def __init__(self, cluster: ClusterSpec, seed: int = 0,
                 window_s: float = 0.1, queue_depth: int = 8,
                 ballast: bool = True, rss_interval: float = 0.2):
        # set before super().__init__ — it launches the start_active rigs
        self.ballast = ballast
        self.rss_interval = rss_interval
        super().__init__(cluster, seed=seed, window_s=window_s,
                         queue_depth=queue_depth)

    def _make_launch(self, trainer: TrainerSpec):
        from repro_torch.data.proc_executor import (ProcessPipeline,
                                                    stage_fns_for)

        def make_pipe(tr, eff, queue_depth):
            return ProcessPipeline(
                tr.pipeline,
                fns=stage_fns_for(tr.pipeline, ballast=self.ballast),
                queue_depth=queue_depth,
                machine=dataclasses.replace(tr.machine, n_cpus=int(eff)),
                rss_interval=self.rss_interval)

        return lambda eff: _TrainerRig(trainer, eff, self.queue_depth,
                                       make_pipe=make_pipe)

    # ------------------------------------------- physics over accounting --
    def _pre_window_oom(self, trainer: TrainerSpec, slot: RigSlot,
                        mem: float) -> bool:
        return False               # the RSS judge rules after the window

    def _post_window_judge(self, trainer: TrainerSpec, slot: RigSlot,
                           mem: float) -> Tuple[float, bool]:
        rss = slot.rig.pipe.rss_mb()
        if rss > trainer.machine.mem_mb:
            slot.kill()
            return rss, True
        return rss, False

    def _discount(self, tput: float, used: int, eff: int) -> float:
        return tput                # contention is physical, already in tput


# ---------------------------------------------------------------------------
# Live clusters: ms-scale stage costs (a window catches tens of batches),
# serial_frac=0 everywhere (sleep workers realize the analytic service
# rate exactly), and 5-stage pipelines throughout so the cached r5
# pretrained agent drives every trainer.
# ---------------------------------------------------------------------------

def live_linear_pipeline(udf_cost: float = 0.03, base_cost: float = 0.004,
                         batch_mb: float = 8.0) -> StageGraph:
    """Skewed 5-stage chain: the UDF dominates, so even placement starves
    it — the live analog of the paper's Fig. 3 cost shares."""
    stages = (
        StageSpec("src", "source", cost=base_cost, serial_frac=0.0,
                  mem_per_worker_mb=64),
        StageSpec("shuffle", "shuffle", cost=base_cost, serial_frac=0.0,
                  mem_per_worker_mb=64),
        StageSpec("feature_udf", "udf", cost=udf_cost, serial_frac=0.0,
                  mem_per_worker_mb=64),
        StageSpec("batch", "batch", cost=base_cost, serial_frac=0.0,
                  mem_per_worker_mb=64),
        StageSpec("prefetch", "prefetch", cost=base_cost, serial_frac=0.0,
                  mem_per_worker_mb=64, mem_per_item_mb=batch_mb),
    )
    return StageGraph("live_lin5", stages, batch_mb=batch_mb)


def live_join_pipeline(batch_mb: float = 8.0) -> StageGraph:
    """5-stage multi-source join DAG at live (ms) scale: sparse reads and
    the feature UDF carry the weight, per Zhao et al."""
    stages = (
        StageSpec("dense_src", "source", cost=0.004, serial_frac=0.0,
                  mem_per_worker_mb=64),
        StageSpec("sparse_src", "source", cost=0.012, serial_frac=0.0,
                  mem_per_worker_mb=64),
        StageSpec("join", "join", cost=0.002, serial_frac=0.0,
                  mem_per_worker_mb=48,
                  inputs=("dense_src", "sparse_src")),
        StageSpec("feature_udf", "udf", cost=0.012, serial_frac=0.0,
                  mem_per_worker_mb=64, inputs=("join",)),
        StageSpec("prefetch", "prefetch", cost=0.004, serial_frac=0.0,
                  mem_per_worker_mb=64, mem_per_item_mb=batch_mb,
                  inputs=("feature_udf",)),
    )
    return StageGraph("live_join5", stages, batch_mb=batch_mb,
                      edge_buffer_mb=8.0)


def live_demo_cluster(ticks: int = 160, pool: int = 10) -> ClusterSpec:
    """The canonical 3-trainer live fleet with churn (fig7_fleet --live).

    Heterogeneity mirrors demo_cluster at live scale: "alpha" is the
    UDF-skewed chain AND memory-tight — an even pool grant pushes its
    even worker split past the 3 GB line (the Fig. 5B crash-loop,
    measured on real executors), while the coordinator's admission
    control clamps under it (and its pool grants carry real marginal
    throughput, +2 CPUs on the UDF lifting 200 -> 250 b/s); "beta" is
    the join DAG, joining a quarter
    of the way in; "gamma" saturates its model at 50 b/s with a handful
    of CPUs, so pool granted there is pure waste. Churn covers all four
    event kinds: join, machine resize, pool re-cap, leave.
    """
    trainers = (
        TrainerSpec("alpha", live_linear_pipeline(),
                    MachineSpec(n_cpus=10, mem_mb=3000.0),
                    model_latency=0.002),
        TrainerSpec("beta", live_join_pipeline(),
                    MachineSpec(n_cpus=8, mem_mb=8192.0),
                    model_latency=0.004, start_active=False),
        TrainerSpec("gamma", live_linear_pipeline(udf_cost=0.004),
                    MachineSpec(n_cpus=6, mem_mb=8192.0),
                    model_latency=0.02),
    )
    events = churn_schedule(ticks, [
        (0.25, "join", "beta", 0),
        (0.55, "resize", "alpha", 6),
        (0.65, "pool", "", 6),
        (0.80, "leave", "gamma", 0),
    ])
    return ClusterSpec("live_fleet3", trainers, shared_pool=pool,
                       events=events)
