"""The port's fleet plane is bitwise the reference on the same seeds: the
data-plane functions it adds (the 5- and 7-stage production pipelines,
`resize_schedule`, `flash_crowd_arrivals`), the cluster specs, FleetSim
under every static fleet policy, the market baselines, FleetEnv, the
Amdahl fit, and — from one seeded npz per pipeline length — the
FleetCoordinator's and the PoolMarket's allocations tick for tick."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.api import FleetSimBackend as JFleetSimBackend  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.core import agent as j_agent  # noqa: E402
from repro.core import baselines as j_baselines  # noqa: E402
from repro.core import env as j_env  # noqa: E402
from repro.core import fleet_coordinator as j_coord  # noqa: E402
from repro.core import optimizer as j_optimizer  # noqa: E402
from repro.core import pretrain as j_pretrain  # noqa: E402
from repro.data import calibrate as j_calibrate  # noqa: E402
from repro.data import fleet as j_fleet  # noqa: E402
from repro.data import pipeline as j_pipeline  # noqa: E402
from repro.data import simulator as j_simulator  # noqa: E402
from repro.data import stream as j_stream  # noqa: E402
from repro_torch.api import FleetSimBackend, RELAUNCH_TICKS, Session  # noqa: E402
from repro_torch.core import baselines, env, fleet_coordinator  # noqa: E402
from repro_torch.core import optimizer, pretrain  # noqa: E402
from repro_torch.data import (calibrate, fleet, pipeline, simulator,  # noqa: E402
                              stream)

STATIC = ("fleet_even", "fleet_proportional", "fleet_local_oracle",
          "fleet_oracle")


def _same_graph(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.edges == want.edges and got.sink == want.sink


def _falloc_key(fa):
    return ({n: (a.workers.tolist(), float(a.prefetch_mb))
             for n, a in fa.allocs.items()}, dict(fa.grants))


# --------------------------------------------------------- data plane -----
def test_production_pipelines_are_the_reference():
    _same_graph(pipeline.custom_pipeline(), j_pipeline.custom_pipeline())
    got = pipeline.multisource_dlrm_pipeline()
    _same_graph(got, j_pipeline.multisource_dlrm_pipeline())
    assert got.n_stages == 7
    _same_graph(pipeline.custom_pipeline(batch_mb=64.0, target_rate=9.0),
                j_pipeline.custom_pipeline(batch_mb=64.0, target_rate=9.0))


@pytest.mark.parametrize("kw", [dict(spike_at_s=30.0, spike_len_s=10.0),
                                dict(spike_at_s=5.0, spike_len_s=2.5,
                                     spike_gain=4.0, diurnal_amp=0.3,
                                     buffer_mb_per_batch=2.0, seed=3)])
def test_flash_crowd_and_stream_pipeline_are_the_reference(kw):
    got = stream.flash_crowd_arrivals(12.0, **kw)
    want = j_stream.flash_crowd_arrivals(12.0, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for t in np.linspace(0.0, 60.0, 41):
        assert got.batches_per_sec(t) == want.batches_per_sec(t)
        assert got.batches_before(t) == want.batches_before(t)
    _same_graph(pipeline.stream_dlrm_pipeline(got, cost_scale=0.5),
                j_pipeline.stream_dlrm_pipeline(want, cost_scale=0.5))


@pytest.mark.parametrize("ticks,caps", [(100, None), (1000, (8, 16, 4))])
def test_resize_schedule_is_the_reference(ticks, caps):
    kw = {} if caps is None else {"caps": caps}
    assert simulator.resize_schedule(ticks, **kw) == \
        j_simulator.resize_schedule(ticks, **kw)


def test_cluster_specs_are_the_reference():
    assert dataclasses.asdict(fleet.demo_cluster(300)) == \
        dataclasses.asdict(j_fleet.demo_cluster(300))
    for seed in (0, 5):
        got = fleet.big_cluster(8, ticks=300, seed=seed)
        want = j_fleet.big_cluster(8, ticks=300, seed=seed)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert isinstance(got, fleet.MarketSpec)
        assert fleet.job_events(got, 7, "leave", "job1") == tuple(
            fleet.FleetEvent(e.tick, e.kind, e.trainer, e.n_cpus)
            for e in j_fleet.job_events(want, 7, "leave", "job1"))


# ---------------------------------------------------------- fleet sim -----
def _run_static(mod_opt, backend_cls, session_cls, cluster, name):
    opt = mod_opt.make_fleet_optimizer(name, cluster, seed=0)
    dead = 0 if name == "fleet_oracle" else RELAUNCH_TICKS
    trace = []

    def collect(t, tel):
        per = tel.get("per_trainer") or {}
        trace.append((tel.throughput, tel.used_cpus, tel.mem_mb, tel.oom,
                      {n: (m["throughput"], m["used_cpus"], m["mem_mb"],
                           m["oom"], m["eff_cpus"]) for n, m in per.items()}))
    res = session_cls(backend_cls(cluster, seed=0), opt).run(
        300, relaunch_dead=dead, collect=collect)
    return trace, res


@pytest.mark.parametrize("name", STATIC)
def test_fleet_sim_trace_is_the_reference_under_static_policies(name):
    got, gres = _run_static(optimizer, FleetSimBackend, Session,
                            fleet.demo_cluster(300), name)
    want, wres = _run_static(j_optimizer, JFleetSimBackend, JSession,
                             j_fleet.demo_cluster(300), name)
    for t, (g, w) in enumerate(zip(got, want)):
        assert g == w, t
    assert len(got) == len(want) == 300
    assert gres.oom_count == wres.oom_count
    assert gres.used_cpus == wres.used_cpus


def _states(cluster_mod, cluster, ticks):
    sim = cluster_mod.FleetSim(cluster, seed=0)
    out = []
    for t in range(ticks[-1] + 1):
        sim.time = t
        if t in ticks:
            out.append(sim.machine)
    return out


def test_market_and_fleet_baselines_are_the_reference_on_big_cluster():
    cluster = fleet.big_cluster(8, ticks=300, seed=0)
    jcluster = j_fleet.big_cluster(8, ticks=300, seed=0)
    ticks = (0, 120, 160, 290)
    for st, jst in zip(_states(fleet, cluster, ticks),
                       _states(j_fleet, jcluster, ticks)):
        assert st.key() == jst.key()
        assert baselines.market_grants(cluster, st) == \
            j_baselines.market_grants(jcluster, jst)
        for name in sorted(baselines.FLEET_BASELINES):
            got = baselines.FLEET_BASELINES[name](cluster, st, 0)
            want = j_baselines.FLEET_BASELINES[name](jcluster, jst, 0)
            assert _falloc_key(got) == _falloc_key(want), (name, st.tick)


def test_fleet_env_observations_and_rewards_are_the_reference():
    e = env.FleetEnv(fleet.demo_cluster(300), seed=0)
    je = j_env.FleetEnv(j_fleet.demo_cluster(300), seed=0)
    assert e.reward_scale == je.reward_scale
    assert np.array_equal(env.even_allocation(pipeline.criteo_pipeline(),
                                              13).workers,
                          j_env.even_allocation(j_pipeline.criteo_pipeline(),
                                                13).workers)
    for _ in range(6):
        obs, jobs = e.observe(), je.observe()
        assert obs.keys() == jobs.keys()
        for n in obs:
            assert obs[n].dtype == jobs[n].dtype
            assert np.array_equal(obs[n], jobs[n]), n
        o, r, m = e.step(e.falloc)
        jo, jr, jm = je.step(je.falloc)
        assert r == jr and m["throughput"] == jm["throughput"]


def test_calibration_fit_is_the_reference():
    workers = [1, 2, 3, 4]
    rates = [1 / (0.05 * (0.2 + 0.8 / a)) for a in workers]
    noisy = [r * f for r, f in zip(rates, (1.01, 0.98, 1.03, 0.995))]
    for rs in (rates, noisy, [rates[0]], [3.0, 3.0]):
        ws = workers[:len(rs)]
        assert calibrate.fit_amdahl(ws, rs) == j_calibrate.fit_amdahl(ws, rs)
    cost, serial = calibrate.fit_amdahl(workers, rates)
    assert cost == pytest.approx(0.05) and serial == pytest.approx(0.2)
    curve = {"workers": [1, 2, 3], "rate": [9.0, 17.0, 24.0],
             "percpu": [0.1, None, 0.11]}
    assert calibrate.corrected_rates(curve) == \
        j_calibrate.corrected_rates(curve)
    for k in (None, 1, 3, 9):
        assert calibrate.default_sweep(k) == j_calibrate.default_sweep(k)
    with pytest.raises(ValueError, match="at least one"):
        calibrate.fit_amdahl([0], [1.0])


def test_clamp_to_memory_is_the_reference():
    spec = pipeline.multisource_dlrm_pipeline()
    jspec = j_pipeline.multisource_dlrm_pipeline()
    for workers, pf, mem in (([4] * 7, 2048.0, 6144.0),
                             ([9, 1, 1, 1, 6, 2, 1], 512.0, 2048.0),
                             ([1] * 7, 64.0, 100.0)):
        got = fleet_coordinator.clamp_to_memory(
            spec, simulator.Allocation(np.array(workers), pf), mem)
        want = j_coord.clamp_to_memory(
            jspec, j_simulator.Allocation(np.array(workers), pf), mem)
        assert got.workers.tolist() == want.workers.tolist()
        assert got.prefetch_mb == want.prefetch_mb


def test_optimizer_registries_match_the_reference():
    spec, machine = pipeline.criteo_pipeline(), simulator.MachineSpec(32)
    with pytest.raises(KeyError) as got:
        optimizer.make_optimizer("nope", spec, machine)
    with pytest.raises(KeyError) as want:
        j_optimizer.make_optimizer("nope", j_pipeline.criteo_pipeline(),
                                   j_simulator.MachineSpec(32))
    assert str(got.value) == str(want.value)
    with pytest.raises(KeyError) as got:
        optimizer.make_fleet_optimizer("nope", fleet.demo_cluster(30))
    with pytest.raises(KeyError) as want:
        j_optimizer.make_fleet_optimizer("nope", j_fleet.demo_cluster(30))
    assert str(got.value) == str(want.value)
    assert sorted(baselines.FLEET_BASELINES) == \
        sorted(j_baselines.FLEET_BASELINES)
    assert baselines.SEEDED == j_baselines.SEEDED
    assert isinstance(optimizer.make_optimizer("plumber", spec, machine),
                      optimizer.StaticOptimizer)


# ------------------------------------------ RL fleet policies, shared npz ---
@pytest.fixture(scope="module")
def shared_agents(tmp_path_factory):
    """One seeded npz per pipeline length of demo_cluster (5 and 7),
    written in the JAX layout and loaded by each package's own loader."""
    d = tmp_path_factory.mktemp("agents")
    got, want = {}, {}
    for n in (5, 7):
        cfg = j_agent.DQNConfig(obs_dim=2 * n + 6, n_stages=n,
                                head="factored")
        path = d / f"dqn_factored_r{n}.npz"
        j_pretrain.save_agent(j_agent.DQNAgent(cfg, seed=n), str(path))
        got[n] = pretrain.load_agent_state(str(path))
        want[n] = j_pretrain.load_agent_state(str(path))
    return got, want


class _Recorder:
    """Records every FleetAllocation the wrapped policy proposes."""

    def __init__(self, opt):
        self.opt, self.name, self.log = opt, opt.name, []

    def propose(self, *a):
        fa = self.opt.propose(*a)
        self.log.append(_falloc_key(fa))
        return fa

    def observe(self, metrics):
        self.opt.observe(metrics)


def _first_divergence(got, want):
    return next((t for t, (g, w) in enumerate(zip(got, want)) if g != w),
                None)


@pytest.mark.parametrize("policy", ["fleet_intune", "market"])
def test_rl_fleet_policies_match_the_reference_from_one_npz(policy,
                                                            shared_agents):
    """300 ticks of demo_cluster(300), the churn at tick 100 ("late"
    joins) inside the window: the port's allocations (per-trainer
    workers, prefetch and pool grants) are the reference's at every
    tick, and so are the agents' weights at the end."""
    got_st, want_st = shared_agents
    cluster, jcluster = fleet.demo_cluster(300), j_fleet.demo_cluster(300)
    assert 100 in {e.tick for e in cluster.events}
    kw = dict(head="factored", finetune_ticks=150)
    if policy == "market":
        port = fleet_coordinator.PoolMarket(
            cluster, inner="fleet_intune", pretrained=got_st, **kw)
        ref = j_coord.PoolMarket(
            jcluster, inner="fleet_intune", pretrained=want_st, **kw)
    else:
        port = fleet_coordinator.FleetCoordinator(cluster,
                                                  pretrained=got_st, **kw)
        ref = j_coord.FleetCoordinator(jcluster, pretrained=want_st, **kw)
    got, want = _Recorder(port), _Recorder(ref)
    gres = Session(FleetSimBackend(cluster, seed=0), got).run(300)
    wres = JSession(JFleetSimBackend(jcluster, seed=0), want).run(300)
    assert len(got.log) == len(want.log) == 300
    flip = _first_divergence(got.log, want.log)
    assert flip is None, f"first diverging tick {flip}"
    assert gres.throughput == wres.throughput
    assert gres.oom_count == wres.oom_count == 0
    sd, jsd = port.state_dict(), ref.state_dict()
    if policy == "market":
        assert sd["budgets"] == jsd["budgets"]
        sd, jsd = sd["inner"], jsd["inner"]
        assert sd.keys() == jsd.keys()
        pairs = [(sd[j]["tuners"], jsd[j]["tuners"]) for j in sd]
    else:
        assert sd["grants"] == jsd["grants"]
        pairs = [(sd["tuners"], jsd["tuners"])]
    for tuners, jtuners in pairs:
        assert tuners.keys() == jtuners.keys()
        for n in tuners:
            a, b = tuners[n], jtuners[n]
            assert a["workers"] == b["workers"], n
            assert a["agent"]["steps"] == b["agent"]["steps"], n
            for layer, p in b["agent"]["qnet"].items():
                for k, v in p.items():
                    np.testing.assert_allclose(
                        a["agent"]["qnet"][layer][k], v, rtol=1e-5,
                        atol=1e-6, err_msg=f"{n} {layer}/{k}")


def test_fleet_coordinator_state_crosses_packages(shared_agents):
    """A port coordinator's state_dict loads into the reference's and
    back (the JAX layout): grants, allocations and Q-network weights
    survive the round trip."""
    got_st, want_st = shared_agents
    cluster, jcluster = fleet.demo_cluster(60), j_fleet.demo_cluster(60)
    kw = dict(head="factored", finetune_ticks=20)
    port = fleet_coordinator.FleetCoordinator(cluster, pretrained=got_st,
                                              **kw)
    Session(FleetSimBackend(cluster, seed=0), port).run(30)
    ref = j_coord.FleetCoordinator(jcluster, pretrained=want_st, **kw)
    JSession(JFleetSimBackend(jcluster, seed=0), ref).run(30)
    ref.load_state_dict(port.state_dict())
    assert ref.grants == port.grants
    back = fleet_coordinator.FleetCoordinator(cluster, pretrained=got_st,
                                              **kw)
    Session(FleetSimBackend(cluster, seed=0), back).run(30)
    back.load_state_dict(ref.state_dict())
    for n, t in port.tuners.items():
        a, b = t.state_dict(), back.tuners[n].state_dict()
        assert a["workers"] == b["workers"]
        for layer, p in a["agent"]["qnet"].items():
            for k, v in p.items():
                assert np.array_equal(v, b["agent"]["qnet"][layer][k])


@pytest.mark.parametrize("factory,make", [
    ("make_fleet_coordinator", lambda f: f.demo_cluster(60)),
    ("make_pool_market", lambda f: f.big_cluster(8, ticks=60)),
])
def test_benchmark_factories_match_the_reference_from_the_cache(
        factory, make, tmp_path, monkeypatch):
    """The benchmark helpers load one cached npz per pipeline length in
    the cluster (written once, in the JAX layout, under each package's
    agent cache) and the policies they build propose the reference's
    allocations at every tick."""
    from benchmarks import common, torch_common
    cluster, jcluster = make(fleet), make(j_fleet)
    lengths = sorted({t.pipeline.n_stages for t in cluster.trainers})
    for n in lengths:
        cfg = j_agent.DQNConfig(obs_dim=2 * n + 6, n_stages=n,
                                head="factored")
        j_pretrain.save_agent(j_agent.DQNAgent(cfg, seed=n),
                              str(tmp_path / f"dqn_factored_r{n}.npz"))
    monkeypatch.setattr(common, "AGENT_DIR", str(tmp_path))
    monkeypatch.setattr(torch_common, "AGENT_DIR", str(tmp_path))
    got = _Recorder(getattr(torch_common, factory)(cluster, seed=0,
                                                   finetune_ticks=20))
    want = _Recorder(getattr(common, factory)(jcluster, seed=0,
                                              finetune_ticks=20))
    gres = Session(FleetSimBackend(cluster, seed=0), got).run(60)
    wres = JSession(JFleetSimBackend(jcluster, seed=0), want).run(60)
    assert _first_divergence(got.log, want.log) is None
    assert gres.throughput == wres.throughput
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        [f"dqn_factored_r{n}.npz" for n in lengths]
