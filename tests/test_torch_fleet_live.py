"""The port's live planes hold the reference's invariants on real threads
and processes: grants are respected, an OOM kill comes with its dead
window, a leave drops no batch, every thread and process is joined, and
a stream's epoch survives a ProcFleet OOM relaunch. Short windows, and
no assertion that ranks allocations by measured rate (host contention
can reorder such rates); rates are the simulator tests' business."""
import multiprocessing as mp
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import agent as j_agent  # noqa: E402
from repro.data import live_fleet as j_live_fleet  # noqa: E402
from repro_torch.api import tune  # noqa: E402
from repro_torch.core.controller import InTune  # noqa: E402
from repro_torch.core.fleet_coordinator import FleetCoordinator  # noqa: E402
from repro_torch.data import calibrate, live_fleet  # noqa: E402
from repro_torch.data.executor import ThreadedPipeline  # noqa: E402
from repro_torch.data.fleet import (ClusterSpec, FleetAllocation,  # noqa: E402
                                    FleetEvent, TrainerSpec, churn_schedule)
from repro_torch.data.live_fleet import (LiveFleet, ProcFleet,  # noqa: E402
                                         live_demo_cluster,
                                         live_join_pipeline,
                                         live_linear_pipeline,
                                         synthetic_stage_fns)
from repro_torch.data.pipeline import (StageGraph, StageSpec,  # noqa: E402
                                       stream_dlrm_pipeline)
from repro_torch.data.proc_executor import (ProcessPipeline,  # noqa: E402
                                            read_cpu_s, stage_fns_for)
from repro_torch.data.simulator import (Allocation, MachineSpec,  # noqa: E402
                                        OOM_RESTART_TICKS, graph_memory_mb)
from repro_torch.data.stream import ArrivalProcess  # noqa: E402


def _wait_threads_settle(base, timeout=3.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate() if t not in base]:
            return []
        time.sleep(0.02)
    return [t for t in threading.enumerate() if t not in base]


def _wait_children_settle(baseline, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not [p for p in mp.active_children() if p not in baseline]:
            return []
        time.sleep(0.05)
    return [p for p in mp.active_children() if p not in baseline]


def spin_pipe(name: str, work_cost: float = 0.02) -> StageGraph:
    return StageGraph(name, (
        StageSpec("src", "source", cost=0.002, serial_frac=0.0,
                  mem_per_worker_mb=16.0),
        StageSpec("work", "udf", cost=work_cost, serial_frac=0.0,
                  mem_per_worker_mb=16.0, inputs=("src",)),
    ), batch_mb=1.0)


def test_live_specs_and_stage_fns_are_the_reference():
    import dataclasses
    for f in ("live_linear_pipeline", "live_join_pipeline"):
        assert dataclasses.asdict(getattr(live_fleet, f)()) == \
            dataclasses.asdict(getattr(j_live_fleet, f)())
    assert dataclasses.asdict(live_demo_cluster(40)) == \
        dataclasses.asdict(j_live_fleet.live_demo_cluster(40))
    fns = synthetic_stage_fns(live_join_pipeline())
    assert set(fns) == {s.name for s in live_join_pipeline().stages}
    assert fns["dense_src"]() == 1                  # source: no args
    assert fns["join"]("x", "y") == ("x", "y")      # join: one per input
    assert fns["feature_udf"]("z") == "z"           # unary: forwards


def test_live_fleet_respects_grants_and_churn_without_drops():
    """Grants over the pool and unknown or missing trainers are refused;
    a granted CPU shows in the trainer's effective cap; join spins a rig
    up, resize re-caps it, leave tears one down with zero dropped
    batches; every thread is joined after close."""
    cluster = ClusterSpec("churny", (
        TrainerSpec("a", live_linear_pipeline(),
                    MachineSpec(n_cpus=8, mem_mb=8192.0)),
        TrainerSpec("b", live_linear_pipeline(),
                    MachineSpec(n_cpus=8, mem_mb=8192.0),
                    start_active=False),
    ), shared_pool=4, events=(
        FleetEvent(2, "join", "b"),
        FleetEvent(4, "resize", "a", n_cpus=4),
        FleetEvent(6, "leave", "b"),
    ))
    ones = Allocation(np.ones(5, dtype=int), 16.0)
    base = set(threading.enumerate())
    lf = LiveFleet(cluster, window_s=0.02)
    try:
        with pytest.raises(ValueError, match="exceed shared pool"):
            lf.apply(FleetAllocation({"a": ones}, {"a": 5}))
        with pytest.raises(ValueError, match="unknown trainers"):
            lf.apply(FleetAllocation({"a": ones}, {"nope": 1}))
        assert set(lf.rigs) == {"a"}
        seen = []
        for _ in range(8):
            st = lf.machine
            seen.append((st.tick, st.active, dict(st.base_cpus)))
            grants = {n: 2 for n in st.active}
            m = lf.apply(FleetAllocation({n: ones for n in st.active},
                                         grants))
            for n, p in m["per_trainer"].items():
                assert p["eff_cpus"] == st.base(n) + 2
            if st.tick == 2:
                with pytest.raises(KeyError, match="active trainer"):
                    lf.apply(FleetAllocation({"a": ones}))
    finally:
        acct = lf.close()
    assert seen[3] == (3, ("a", "b"), {"a": 8, "b": 8})
    assert seen[5][2] == {"a": 4, "b": 8}
    assert seen[7] == (7, ("a",), {"a": 4})
    assert acct["dropped_batches"] == 0 and acct["oom_count"] == 0
    assert acct["all_joined"]
    assert _wait_threads_settle(base) == []


def test_live_fleet_oom_kill_pays_the_dead_window():
    pipe = live_linear_pipeline()
    cluster = ClusterSpec("oomy", (
        TrainerSpec("a", pipe, MachineSpec(n_cpus=8, mem_mb=2500.0)),
    ), shared_pool=0)
    fat = FleetAllocation(
        {"a": Allocation(np.full(5, 2, dtype=int), 1024.0)})
    assert graph_memory_mb(pipe, fat.allocs["a"].workers, 1024.0) > 2500.0
    ok = FleetAllocation({"a": Allocation(np.ones(5, dtype=int), 16.0)})
    with LiveFleet(cluster, window_s=0.01) as lf:
        m = lf.apply(fat)
        assert m["oom"] and m["restarting"] and lf.oom_count == 1
        assert "a" not in lf.rigs                   # the process was killed
        for _ in range(OOM_RESTART_TICKS):
            m = lf.apply(ok)
            assert m["restarting"] and not m["oom"]
            assert m["throughput"] == 0.0
        assert "a" in lf.rigs                       # relaunched
        assert not lf.apply(ok)["restarting"]


def _agents():
    """Seeded r5 agent weights in the JAX layout (live clusters are all
    5-stage pipelines)."""
    cfg = j_agent.DQNConfig(obs_dim=16, n_stages=5, head="factored")
    return {5: j_agent.DQNAgent(cfg, seed=5).state_dict()}


def test_coordinator_on_live_fleet_drops_nothing_and_joins_every_thread():
    """tune(..., backend="live") over live_demo_cluster's churn (a join,
    a resize, a pool re-cap and a leave) with the FleetCoordinator:
    zero OOMs, zero dropped batches, every thread joined."""
    ticks = 40
    cluster = live_demo_cluster(ticks)
    coord = FleetCoordinator(cluster, pretrained=_agents(), head="factored",
                             finetune_ticks=20)
    base = set(threading.enumerate())
    res = tune(cluster, optimizer=coord, backend="live", ticks=ticks,
               backend_kw={"window_s": 0.02})
    live = res.extras["live"]
    assert res.ticks == ticks and res.oom_count == 0
    assert live["dropped_batches"] == 0 and live["crash_lost"] == 0
    assert live["all_joined"]
    assert _wait_threads_settle(base) == []
    for h in coord.history:
        assert sum(h["grants"].values()) <= cluster.shared_pool


def test_intune_legacy_live_mode_tunes_a_threaded_pipeline():
    spec = live_linear_pipeline()
    machine = MachineSpec(n_cpus=8, mem_mb=8192.0)
    base = set(threading.enumerate())
    pipe = ThreadedPipeline(spec, fns=synthetic_stage_fns(spec),
                            queue_depth=4, machine=machine)
    tuner = InTune(spec, machine, seed=0, head="factored",
                   pretrained=_agents()[5])
    try:
        tuner.attach(pipe, interval_s=0.02)
        for _ in range(4):
            time.sleep(0.02)
            stats = tuner.live_tick()
            assert set(stats) >= {"throughput", "stage_latency", "workers"}
            w = np.asarray(pipe.worker_counts())
            assert len(w) == 5 and w.min() >= 1 and w.sum() <= 8 * 5
            assert tuner.obs.shape == (16,)
    finally:
        acct = pipe.shutdown(drain=False)
    assert acct["joined"]
    assert _wait_threads_settle(base) == []


# --------------------------------------------------------- process plane ---
def test_stream_epoch_survives_a_proc_fleet_oom_relaunch():
    """Kill a stream trainer, pay a dead window, and the relaunched
    ProcessPipeline resumes the arrival curve: same t0, emitted tokens
    kept, stream time spanning the gap."""
    arr = ArrivalProcess(users=1_000_000, events_per_user_s=1e-3,
                         events_per_batch=20)          # 50 batches/s
    spec = stream_dlrm_pipeline(arr, cost_scale=0.05, batch_mb=1.0)
    cluster = ClusterSpec("stream_proc1", (
        TrainerSpec("s", spec, MachineSpec(n_cpus=2, mem_mb=4096.0)),
    ), shared_pool=0)
    fa = FleetAllocation(
        {"s": Allocation(np.ones(spec.n_stages, dtype=int), 4.0)})
    baseline = list(mp.active_children())
    fleet = ProcFleet(cluster, window_s=0.05, ballast=False)
    try:
        slot = fleet.slots["s"]
        deadline = time.monotonic() + 10.0
        pre = None
        while time.monotonic() < deadline:      # workers spawn async
            fleet.apply(fa)
            pre = slot.rig.pipe.stream_epoch()
            if pre["emitted"] > 0:
                break
        assert pre is not None and pre["emitted"] > 0
        slot.kill()
        assert slot.restart_left == OOM_RESTART_TICKS
        assert slot.carry_epoch["emitted"] >= pre["emitted"]
        carried = dict(slot.carry_epoch)
        slot.restart_left = 1           # collapse the dead window
        time.sleep(0.3)                 # ... but let stream time run on
        m = fleet.apply(fa)             # relaunch + adopt happens here
        assert m["per_trainer"]["s"]["restarting"]
        post = slot.rig.pipe.stream_epoch()
        assert post["t0"] == carried["t0"]
        assert post["emitted"] >= carried["emitted"]
        assert slot.carry_epoch is None
        st = slot.rig.pipe.stream_state()
        assert st["t"] >= 0.3           # stream time spans the dead gap
    finally:
        acct = fleet.close()
    assert acct["all_joined"], acct
    assert _wait_children_settle(baseline) == []


def test_adopt_stream_epoch_round_trips_and_cpu_clock_reads():
    arr = ArrivalProcess(users=1_000_000, events_per_user_s=1e-3,
                         events_per_batch=20)
    spec = stream_dlrm_pipeline(arr, cost_scale=0.05, batch_mb=1.0)
    epoch = {"emitted": 37, "t0": 123.456}
    p = ProcessPipeline(spec, fns=stage_fns_for(spec, ballast=False),
                        machine=MachineSpec(n_cpus=1, mem_mb=4096.0))
    try:
        p.adopt_stream_epoch(epoch)
        assert p.stream_epoch() == epoch
        p.adopt_stream_epoch(None)      # None epoch: no-op
        assert p.stream_epoch() == epoch
        assert all(pool.cpu_s() >= 0.0 for pool in p.pools)
    finally:
        p.shutdown(drain=False)
    plain = spin_pipe("noepoch")
    q = ProcessPipeline(plain, fns=stage_fns_for(plain, ballast=False),
                        machine=MachineSpec(n_cpus=1, mem_mb=4096.0))
    try:
        assert q.stream_epoch() is None
        q.adopt_stream_epoch(epoch)     # non-stream graph: no-op
        assert q.stream_epoch() is None
    finally:
        q.shutdown(drain=False)
    import os
    assert read_cpu_s(os.getpid()) > 0.0


def test_proc_fleet_churn_leaks_no_process():
    """Joins, leaves, a resize and a pool re-cap over a 2-trainer
    ProcessPipeline fleet under the coordinator: zero OOMs, zero
    crash-lost batches, every process joined and reaped."""
    ticks = 16
    cluster = ClusterSpec("proc_churn2", (
        TrainerSpec("a", spin_pipe("sa"), MachineSpec(3, 4096.0)),
        TrainerSpec("b", spin_pipe("sb", 0.03), MachineSpec(3, 4096.0)),
    ), shared_pool=2, events=churn_schedule(ticks, [
        (0.2, "leave", "b", 0),
        (0.4, "join", "b", 0),
        (0.6, "resize", "a", 2),
        (0.8, "pool", "", 1),
    ]))
    baseline = list(mp.active_children())
    res = tune(cluster, optimizer="fleet_even", backend="proc", ticks=ticks,
               relaunch_dead=2,
               backend_kw={"window_s": 0.05, "ballast": False})
    live = res.extras["live"]
    assert res.oom_count == 0 and live["crash_lost"] == 0, live
    assert live["all_joined"], live
    assert _wait_children_settle(baseline) == []


def test_measured_stage_curve_fits_a_spin_stage():
    """The calibrator's sweep on a real process pool: one point per
    worker count, a positive rate and a CPU clock at each, and a finite
    Amdahl fit of the corrected curve."""
    st = StageSpec("work", "udf", cost=0.01, serial_frac=0.0,
                   mem_per_worker_mb=8.0)
    baseline = list(mp.active_children())
    # the calibrator's own settle time: a freshly spawned worker of a
    # stage this cheap recalibrates its spin clock first, and on a busy
    # host 0.1 s did not cover that (a window of 0 items)
    curve = calibrate.measure_stage_curve(st, (1, 2), window_s=0.3,
                                          warmup_s=0.5)
    assert curve["workers"] == [1, 2]
    assert all(r > 0.0 for r in curve["rate"])
    assert all(0.0 <= o <= 1.0 for o in curve["occupancy"])
    cost, serial = calibrate.fit_amdahl(curve["workers"],
                                        calibrate.corrected_rates(curve))
    assert cost > 0.0 and 0.0 <= serial <= 1.0
    assert _wait_children_settle(baseline) == []
