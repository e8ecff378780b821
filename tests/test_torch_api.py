"""The port's public tuning API: `repro_torch.api` exports what
`repro.api` exports, `tune` is bitwise the reference on the sim planes,
`Session.run` keeps the reference's loop contract (events before the
proposal, capacity read at propose time, `relaunch_dead` on a change,
dead windows), and every registered backend meets the Backend contract
(the port of tests/test_backend_contract.py: seven cases, ms-scale
specs, ballast off)."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro.core import baselines as j_B  # noqa: E402
from repro.core.optimizer import make_optimizer as j_make_optimizer  # noqa: E402
from repro.data import fleet as j_fleet  # noqa: E402
from repro.data import pipeline as j_pipeline  # noqa: E402
from repro.data import simulator as j_simulator  # noqa: E402
from repro_torch.api import (AllocationError, Backend, ChurnEvent,  # noqa: E402
                             DeadWindow, RELAUNCH_TICKS, ResizeEvent,
                             RunResult, Session, SimBackend, Telemetry,
                             UnsupportedEventError, make_backend,
                             resize_events, tune, validate_allocation,
                             validate_fleet_allocation)
from repro_torch.core import baselines as B  # noqa: E402
from repro_torch.core.optimizer import make_optimizer  # noqa: E402
from repro_torch.data.fleet import (ClusterSpec, FleetAllocation,  # noqa: E402
                                    FleetEvent, FleetSim, JobSpec,
                                    MarketSpec, TrainerSpec, demo_cluster)
from repro_torch.data.live_fleet import live_linear_pipeline  # noqa: E402
from repro_torch.data.pipeline import criteo_pipeline  # noqa: E402
from repro_torch.data.simulator import (Allocation, MachineSpec,  # noqa: E402
                                        PipelineSim, resize_schedule)

SPEC = criteo_pipeline()
MACHINE = MachineSpec(n_cpus=64, mem_mb=65536.0)


# ------------------------------------------------------------ surface -----
def test_api_exports_what_the_reference_exports():
    assert sorted(api.__all__) == sorted(japi.__all__)
    for name in api.__all__:
        obj, ref = getattr(api, name), getattr(japi, name)
        if isinstance(obj, (type, type(tune))):
            assert obj.__module__.startswith("repro_torch."), name
        elif isinstance(obj, (int, float)):
            assert obj == ref, name           # the runtime constants
    assert sorted(api.BACKENDS) == sorted(japi.BACKENDS)
    assert {k: v.__name__ for k, v in api.BACKENDS.items()} == \
        {k: v.__name__ for k, v in japi.BACKENDS.items()}


def _same_run(got, want):
    for k in RunResult._FIELDS:
        assert got[k] == want[k], k
    assert got.extras.keys() == want.extras.keys()
    assert got.extras["optimizer"].name == want.extras["optimizer"].name


@pytest.mark.parametrize("optimizer", ["heuristic", "oracle"])
def test_tune_on_the_sim_plane_is_the_reference(optimizer):
    got = tune(SPEC, MachineSpec(64), optimizer=optimizer, backend="sim",
               ticks=300, events=[ResizeEvent(150, 32)], relaunch_dead=5)
    want = japi.tune(j_pipeline.criteo_pipeline(), j_simulator.MachineSpec(64),
                     optimizer=optimizer, backend="sim", ticks=300,
                     events=[japi.ResizeEvent(150, 32)], relaunch_dead=5)
    _same_run(got, want)
    assert min(got.throughput[:150]) > 0.0


def test_tune_fleet_oracle_is_the_reference():
    got = tune(demo_cluster(300), optimizer="fleet_oracle", ticks=300)
    want = japi.tune(j_fleet.demo_cluster(300), optimizer="fleet_oracle",
                     ticks=300)
    _same_run(got, want)
    assert got.oom_count == 0 and got.extras["optimizer"].name == \
        "fleet_oracle"


# ------------------------------------------------------------ session -----
# Each Session scenario runs through both packages on the same spec,
# machine and events; every RunResult field must agree bit for bit, and
# the reference's own assertions (tests/test_api_session.py) hold too.
PORT = SimpleNamespace(api=api, B=B, make_optimizer=make_optimizer,
                       spec=SPEC, machine=MACHINE, PipelineSim=PipelineSim)
REF = SimpleNamespace(api=japi, B=j_B, make_optimizer=j_make_optimizer,
                      spec=j_pipeline.criteo_pipeline(),
                      machine=j_simulator.MachineSpec(n_cpus=64,
                                                      mem_mb=65536.0),
                      PipelineSim=j_simulator.PipelineSim)


def _session_run(pkg, optimizer, ticks, events=(), **kw):
    """`optimizer` is a registry name or a factory of an Optimizer."""
    opt = pkg.make_optimizer(optimizer, pkg.spec, pkg.machine) \
        if isinstance(optimizer, str) else optimizer(pkg)
    backend = pkg.api.SimBackend(pkg.spec, pkg.machine, seed=0)
    return pkg.api.Session(backend, opt).run(ticks, events=list(events),
                                             **kw)


def _both(optimizer, ticks, events=lambda a: [], **kw):
    got = _session_run(PORT, optimizer, ticks, events(api), **kw)
    want = _session_run(REF, optimizer, ticks, events(japi), **kw)
    _same_run(got, want)
    return got


def test_session_resize_event_changes_capacity_mid_run():
    res = _both("heuristic", 10, lambda a: [a.ResizeEvent(5, 32)])
    assert res.used_cpus[4] > res.used_cpus[5]          # re-proposed at 32
    assert res.ticks == 10


def test_session_dead_window_zeroes_ticks():
    res = _both("oracle", 8, lambda a: [a.DeadWindow(2, 3)])
    assert res.throughput[0] > 0.0 and res.throughput[5] > 0.0
    assert res.throughput[2:5] == [0.0, 0.0, 0.0]
    assert res.used_cpus[2:5] == [0, 0, 0]


def test_session_relaunch_dead_charged_on_proposal_change():
    res = _both("heuristic", 10, lambda a: [a.ResizeEvent(4, 32)],
                relaunch_dead=3)
    assert res.throughput[3] > 0.0
    assert res.throughput[4:7] == [0.0, 0.0, 0.0]       # re-proposal paid
    assert res.throughput[7] > 0.0


def test_session_dead_window_overlapping_a_relaunch_is_the_reference():
    """A scheduled DeadWindow longer than the relaunch window is never
    truncated by it, and one that starts inside it extends it."""
    res = _both("heuristic", 30,
                lambda a: [a.ResizeEvent(4, 32), a.DeadWindow(5, 6),
                           a.DeadWindow(18, 2), a.ResizeEvent(19, 16)],
                relaunch_dead=3)
    assert res.throughput[4:11] == [0.0] * 7
    assert res.throughput[11] > 0.0
    assert res.throughput[18:22] == [0.0] * 4


def test_session_injects_events_before_the_proposal():
    """Events due at tick t reach the backend before the tick's
    proposal, and the capacity a tick's used_cpus is clamped to is the
    one read at propose time."""
    seen = {}

    def probe(pkg):
        caps = seen.setdefault(pkg.api.__name__, [])

        class Probe:
            name = "probe"

            def propose(self, spec, machine, stats=None):
                caps.append(machine.n_cpus)
                return pkg.B.heuristic_even(spec, machine)

            def observe(self, metrics):
                pass
        return Probe()

    res = _both(probe, 6, lambda a: [a.ResizeEvent(3, 16),
                                     a.ResizeEvent(5, 8)])
    assert seen["repro_torch.api"] == seen["repro.api"] == \
        [64, 64, 64, 16, 16, 8]
    assert all(u <= c for u, c in zip(res.used_cpus, seen["repro.api"]))


def test_session_collect_sees_telemetry_every_tick():
    seen = {PORT.api.__name__: [], REF.api.__name__: []}
    for pkg in (PORT, REF):
        _session_run(pkg, "oracle", 4, collect=lambda t, tel, pkg=pkg:
                     seen[pkg.api.__name__].append((t, tel)))
    got, want = seen["repro_torch.api"], seen["repro.api"]
    assert [t for t, _ in got] == [0, 1, 2, 3]
    assert all(isinstance(tel, Telemetry) for _, tel in got)
    assert [(t, dict(tel)) for t, tel in got] == \
        [(t, dict(tel)) for t, tel in want]


def test_run_result_is_mapping_compatible():
    res = _both("oracle", 3)
    assert isinstance(res, RunResult)
    assert res["throughput"] == res.throughput
    assert res["oom_count"] == res.oom_count == 0
    assert res.get("missing") is None and "mem_mb" in res
    assert set(res.to_dict()) >= {"throughput", "used_cpus", "mem_mb",
                                  "oom_count"}


def test_self_driving_controller_backend_runs_without_an_optimizer():
    from repro_torch.api import ControllerBackend
    from repro_torch.core.controller import InTune
    tuner = InTune(SPEC, MachineSpec(n_cpus=32), seed=0, head="factored",
                   finetune_ticks=5)
    res = Session(ControllerBackend(tuner)).run(6)
    assert res.ticks == 6 and min(res.throughput) > 0.0


# --------------------------------------------------------------- tune -----
def test_tune_one_liner_sim():
    res = tune(SPEC, MACHINE, optimizer="oracle", backend="sim", ticks=5)
    assert res.ticks == 5 and min(res.throughput) > 0
    assert res.extras["optimizer"].name == "oracle"


def test_tune_one_liner_fleet():
    res = tune(demo_cluster(40), optimizer="fleet_even", backend="sim",
               ticks=8, relaunch_dead=2)
    assert res.ticks == 8
    assert res.extras["optimizer"].name == "fleet_even"


def _same_error(exc, match, port_call, ref_call):
    """Both packages raise the same type with the same message."""
    with pytest.raises(exc, match=match) as got:
        port_call()
    with pytest.raises(exc) as want:
        ref_call()
    assert str(got.value) == str(want.value)


def test_make_backend_rejects_unknown_names():
    j_spec, j_machine = REF.spec, REF.machine
    _same_error(KeyError, "unknown single backend",
                lambda: make_backend("warp_drive", SPEC, MACHINE),
                lambda: japi.make_backend("warp_drive", j_spec, j_machine))
    _same_error(KeyError, "unknown fleet backend",
                lambda: make_backend("warp_drive", demo_cluster(10)),
                lambda: japi.make_backend("warp_drive",
                                          j_fleet.demo_cluster(10)))
    _same_error(TypeError, "needs a MachineSpec",   # machine=None
                lambda: make_backend("sim", SPEC),
                lambda: japi.make_backend("sim", j_spec))
    _same_error(TypeError, "silently ignored",
                lambda: make_backend("sim", demo_cluster(10), MACHINE),
                lambda: japi.make_backend("sim", j_fleet.demo_cluster(10),
                                          j_machine))
    _same_error(KeyError, "unknown optimizer",
                lambda: tune(SPEC, MACHINE, optimizer="nope",
                             backend="proc"),
                lambda: japi.tune(j_spec, j_machine, optimizer="nope",
                                  backend="proc"))
    _same_error(KeyError, "unknown fleet optimizer",
                lambda: tune(demo_cluster(10), optimizer="nope"),
                lambda: japi.tune(j_fleet.demo_cluster(10),
                                  optimizer="nope"))


def test_wrapped_executor_counts_oom_entries_without_killing():
    from repro_torch.api import ExecutorBackend
    from repro_torch.data.executor import ThreadedPipeline
    from repro_torch.data.live_fleet import synthetic_stage_fns
    spec = live_linear_pipeline()
    pipe = ThreadedPipeline(spec, fns=synthetic_stage_fns(spec),
                            queue_depth=4,
                            machine=MachineSpec(n_cpus=4, mem_mb=2500.0))
    backend = ExecutorBackend.wrap(pipe, window_s=0.02)
    try:
        ok = Allocation(np.ones(5, dtype=int), prefetch_mb=16.0)
        over = Allocation(np.full(5, 3, dtype=int), prefetch_mb=16.0)
        assert backend.apply(ok).oom is False
        # two consecutive over-budget ticks = ONE observed OOM entry;
        # wrap mode reports, it never kills the user's process
        assert backend.apply(over).oom is True
        assert backend.apply(over).oom is True
        assert backend.oom_count == 1
        assert backend.apply(ok).oom is False
        assert backend.apply(over).oom is True      # re-entry counts again
        assert backend.oom_count == 2
    finally:
        acct = backend.shutdown()
    assert acct["all_joined"] is True


# --------------------------------------------------------- validation -----
def test_validate_fleet_allocation():
    cluster = demo_cluster(40)
    ok = {t.name: Allocation(np.ones(t.pipeline.n_stages, dtype=int), 8.0)
          for t in cluster.trainers}
    validate_fleet_allocation(cluster, FleetAllocation(dict(ok), {"big": 1}))
    with pytest.raises(AllocationError, match="unknown trainer"):
        validate_fleet_allocation(cluster, FleetAllocation(
            {"nope": Allocation(np.ones(5, dtype=int))}))
    with pytest.raises(AllocationError, match="trainer 'big'"):
        bad = dict(ok)
        bad["big"] = Allocation(np.array([1, 1, -1, 1, 1]))
        validate_fleet_allocation(cluster, FleetAllocation(bad))
    with pytest.raises(AllocationError, match="negative pool grant"):
        validate_fleet_allocation(
            cluster, FleetAllocation(dict(ok), {"big": -2}))
    with pytest.raises(AllocationError, match="5 stages"):
        validate_allocation(SPEC, Allocation(np.ones(3, dtype=int)))


def test_sim_backend_rejects_bad_allocation_before_apply():
    backend = SimBackend(SPEC, MACHINE, seed=0)
    with pytest.raises(AllocationError):
        backend.apply(Allocation(np.ones(7, dtype=int)))
    assert backend.snapshot()["time"] == 0      # nothing was applied


def test_readapt_protocol_matches_a_hand_rolled_loop():
    """ResizeEvent + DeadWindow through Session.run reproduce the
    pre-API static loop exactly, including the relaunch window paid at
    every scheduled resize tick (even a same-cap re-cap), in both
    packages and bit for bit between them."""
    resizes = [(0, 64), (20, 32)]
    rmap = dict(resizes)

    def readapt(pkg):
        class Readapt(pkg.api.FrozenPolicy):
            name = "readapt"

            def __init__(self, alloc):
                super().__init__(alloc)
                self.t = 0

            def propose(self, spec, machine, stats=None):
                if self.t in rmap:
                    self.alloc = pkg.B.heuristic_even(spec, machine)
                self.t += 1
                return self.alloc
        return Readapt(pkg.B.heuristic_even(pkg.spec, pkg.machine))

    def events(a):
        return a.resize_events(resizes) + [
            a.DeadWindow(t, a.RELAUNCH_TICKS) for t, _ in resizes]

    res = _both(readapt, 50, events)
    for pkg in (PORT, REF):
        sim = pkg.PipelineSim(pkg.spec, pkg.machine, seed=0)
        tput, mem, used = [], [], []
        dead, cur = 0, pkg.B.heuristic_even(pkg.spec, pkg.machine)
        for t in range(50):
            if t in rmap:
                sim.resize(rmap[t])
                cur = pkg.B.heuristic_even(pkg.spec, sim.machine)
                dead = RELAUNCH_TICKS
            if dead > 0:
                dead -= 1
                m = {"throughput": 0.0, "mem_mb": 0.0, "used_cpus": 0}
                sim.time += 1
            else:
                m = sim.apply(cur)
            tput.append(m["throughput"])
            used.append(min(m["used_cpus"], sim.machine.n_cpus))
            mem.append(m["mem_mb"])
        assert list(res["throughput"]) == tput
        assert list(res["used_cpus"]) == used
        assert list(res["mem_mb"]) == mem


def test_resize_events_lift_the_legacy_schedule():
    evs = resize_events(resize_schedule(100))
    assert evs[0] == ResizeEvent(0, 32)
    assert [e.tick for e in evs] == [0, 20, 40, 60, 80]
    assert RELAUNCH_TICKS == japi.RELAUNCH_TICKS == 20


def test_job_churn_events_expand_per_member():
    market = MarketSpec("m", (
        TrainerSpec("a", SPEC, MachineSpec(8)),
        TrainerSpec("b", SPEC, MachineSpec(8)),
        TrainerSpec("c", SPEC, MachineSpec(8))), shared_pool=4,
        jobs=(JobSpec("j0", ("a", "c")), JobSpec("j1", ("b",))))
    evs = api.job_churn_events(market, [(5, "leave", "j0"),
                                        (9, "join", "j1")])
    assert evs == [ChurnEvent(5, "leave", "a"), ChurnEvent(5, "leave", "c"),
                   ChurnEvent(9, "join", "b")]
    with pytest.raises(ValueError, match="join/leave only"):
        api.job_churn_events(market, [(1, "resize", "j0")])


def test_fleet_backend_inject_event_merges_pending_tail():
    sim = FleetSim(demo_cluster(100), seed=0)   # late joins at tick 33
    sim.inject_event(FleetEvent(tick=5, kind="leave", trainer="mid"))
    assert "mid" in sim.machine.active          # tick 0: not yet
    sim.time = 5
    assert "mid" not in sim.machine.active
    sim.time = 33
    assert "late" in sim.machine.active         # original schedule intact


# ---------------------------------------------- the Backend contract ------
BACKENDS = ["sim", "executor", "proc", "fleet_sim", "fleet_live",
            "fleet_proc", "fleet_market"]
FLEET = {"fleet_sim", "fleet_live", "fleet_proc", "fleet_market"}
SEEDED = {"sim", "fleet_sim", "fleet_market"}  # analytic: same seed, same bytes
LIVE = {"executor", "proc", "fleet_live", "fleet_proc"}  # threads / processes
LIVE_KW = {"window_s": 0.04}
# model_latency throttles the single-machine rigs' background
# consumption: the contract is asserted, not rates
SINGLE_KW = {**LIVE_KW, "model_latency": 0.1}


def _spec():
    return live_linear_pipeline()         # 5 stages, ms-scale costs


def _cluster():
    trainers = tuple(
        TrainerSpec(n, _spec(), MachineSpec(n_cpus=4, mem_mb=4096.0),
                    model_latency=0.01) for n in ("a", "b"))
    return ClusterSpec("contract_fleet", trainers, shared_pool=4)


def _market():
    base = _cluster()
    return MarketSpec("contract_market", base.trainers, shared_pool=4,
                      jobs=(JobSpec("j0", ("a",), weight=2.0, floor=1),
                            JobSpec("j1", ("b",))))


def _make(name: str, seed: int = 0) -> Backend:
    machine = MachineSpec(n_cpus=8, mem_mb=4096.0)
    if name == "sim":
        return make_backend("sim", _spec(), machine, seed=seed)
    if name == "executor":
        return make_backend("executor", _spec(), machine, seed=seed,
                            **SINGLE_KW)
    if name == "proc":
        return make_backend("proc", _spec(), machine, seed=seed,
                            ballast=False, **SINGLE_KW)
    if name == "fleet_sim":
        return make_backend("sim", _cluster(), seed=seed)
    if name == "fleet_market":
        return make_backend("sim", _market(), seed=seed)
    if name == "fleet_proc":
        return make_backend("proc", _cluster(), seed=seed, ballast=False,
                            **LIVE_KW)
    return make_backend("live", _cluster(), seed=seed, **LIVE_KW)


def _alloc(name: str, backend: Backend, workers=(1, 1, 1, 1, 1)):
    one = Allocation(np.asarray(workers, dtype=int), prefetch_mb=16.0)
    if name in FLEET:
        state = backend.machine
        allocs = {n: Allocation(np.ones(5, dtype=int), prefetch_mb=16.0)
                  for n in state.active}
        allocs[state.active[0]] = one
        return FleetAllocation(allocs, {n: 0 for n in state.active})
    return one


@pytest.fixture(params=BACKENDS)
def case(request):
    backend = _make(request.param)
    yield request.param, backend
    backend.shutdown()


def test_apply_returns_full_telemetry(case):
    name, backend = case
    tel = backend.apply(_alloc(name, backend))
    assert isinstance(tel, Telemetry)
    assert isinstance(tel.throughput, float) and tel.throughput >= 0.0
    assert isinstance(tel.mem_mb, float) and tel.mem_mb > 0.0
    # fleet aggregates clamp each trainer's 5 workers to its 4 owned CPUs
    assert isinstance(tel.used_cpus, int) and tel.used_cpus == (
        8 if name in FLEET else 5)
    assert tel.oom is False and tel.restarting is False
    assert tel["throughput"] == tel.throughput
    assert "mem_mb" in tel and tel.get("nope", 42) == 42
    assert set(dict(tel)) >= {"throughput", "mem_mb", "used_cpus",
                              "oom", "restarting"}
    if name in FLEET:
        assert set(tel["per_trainer"]) == set(backend.machine.active)


def test_skip_tick_advances_clock_and_zeroes(case):
    name, backend = case
    t0 = backend.snapshot()["time"]
    tel = backend.skip_tick()
    assert tel.throughput == 0.0 and tel.restarting is True
    assert backend.snapshot()["time"] == t0 + 1


def test_inject_resize_changes_capacity(case):
    name, backend = case
    backend.apply(_alloc(name, backend))
    before = backend.capacity
    if name in FLEET:
        # fleet dialect: ResizeEvent re-caps the shared pool
        backend.inject(ResizeEvent(tick=1, n_cpus=1))
        assert backend.capacity == before - 3        # pool 4 -> 1
    else:
        backend.inject(ResizeEvent(tick=1, n_cpus=3))
        assert backend.capacity == 3
    assert isinstance(backend.apply(_alloc(name, backend)), Telemetry)


def test_churn_injection(case):
    name, backend = case
    if name not in FLEET:
        with pytest.raises(UnsupportedEventError):
            backend.inject(ChurnEvent(tick=0, kind="leave", trainer="a"))
        with pytest.raises(UnsupportedEventError, match="DeadWindow"):
            backend.inject(DeadWindow(tick=0, ticks=2))
        return
    assert set(backend.machine.active) == {"a", "b"}
    backend.inject(ChurnEvent(tick=0, kind="leave", trainer="b"))
    assert set(backend.machine.active) == {"a"}
    tel = backend.apply(_alloc(name, backend))
    assert set(tel["per_trainer"]) == {"a"}
    backend.inject(ChurnEvent(tick=1, kind="join", trainer="b"))
    assert set(backend.machine.active) == {"a", "b"}
    tel = backend.apply(_alloc(name, backend))
    assert set(tel["per_trainer"]) == {"a", "b"}
    with pytest.raises(ValueError):
        backend.inject(ChurnEvent(tick=2, kind="leave", trainer="nope"))
    with pytest.raises(ValueError):
        backend.inject(ChurnEvent(tick=2, kind="explode", trainer="a"))


def test_shutdown_idempotent(case):
    name, backend = case
    backend.apply(_alloc(name, backend))
    first = backend.shutdown()
    second = backend.shutdown()
    assert first is second          # cached accounting, not a re-teardown
    if name in LIVE:
        assert first["all_joined"] is True
        assert first["oom_count"] == 0
    with pytest.raises(RuntimeError, match="shut down"):
        backend.apply(_alloc(name, backend))


def test_snapshot_has_clock_and_ooms(case):
    name, backend = case
    snap = backend.snapshot()
    assert snap["time"] == 0 and snap["oom_count"] == 0
    backend.apply(_alloc(name, backend))
    assert backend.snapshot()["time"] == 1


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_snapshot_deterministic_for_seeded_backends(name):
    def trace(seed):
        backend = _make(name, seed=seed)
        tels = [backend.apply(_alloc(name, backend)) for _ in range(5)]
        return ([(t.throughput, t.mem_mb, t.used_cpus) for t in tels],
                backend.snapshot())
    assert trace(3) == trace(3)


def test_invalid_allocation_rejected_at_the_boundary(case):
    name, backend = case
    with pytest.raises(AllocationError):
        backend.apply(_alloc(name, backend, workers=(1, -1, 1, 1, 1)))


def test_session_drives_every_backend(case):
    name, backend = case

    class Hold:
        name = "hold"

        def propose(self, spec, machine, stats=None):
            return _alloc(name, backend)

        def observe(self, metrics):
            self.last = metrics

    opt = Hold()
    res = Session(backend, opt).run(3)
    assert res.ticks == 3 and len(res.used_cpus) == 3
    assert isinstance(opt.last, Telemetry)
    assert res.oom_count == 0
