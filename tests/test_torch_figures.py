"""The port's figure benchmarks against the reference's on the same tree.

Both packages load one seeded npz per pipeline length (written in the JAX
layout into `tmp_path`, each package's AGENT_DIR pointed at it, so that
nothing pretrains and neither package's own cache is touched) and write
their JSON into `tmp_path` too (each OUT_DIR pointed there: a reference run
made here never overwrites experiments/bench/, which tests/test_golden.py
reads). On the sim plane every figure is held bitwise to the reference's
run: fig5's rows, fig7's summaries and per-policy timelines, fig8's three
panels, the pool market's summary and fig_stream's sim arm row for row
(the reference's sim arm repeats itself from one npz; it is run twice
here to show it). A float32 TD update that flipped an argmax would show as
the first differing tick, which the assertions name. The real-process
arms (the market's, the stream's and the calibration) are held to
invariants, never to measured rates."""
import contextlib
import dataclasses
import functools
import io
import json
import math
import multiprocessing as mp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import common, torch_common  # noqa: E402
from benchmarks import fig5_static as j_fig5  # noqa: E402
from benchmarks import fig7_rescale as j_fig7  # noqa: E402
from benchmarks import fig8_scaling as j_fig8  # noqa: E402
from benchmarks import fig_market as j_market  # noqa: E402
from benchmarks import fig_stream as j_stream  # noqa: E402
from benchmarks import proc_calibration as j_cal  # noqa: E402
from benchmarks import torch_fig5_static as fig5  # noqa: E402
from benchmarks import torch_fig7_rescale as fig7  # noqa: E402
from benchmarks import torch_fig8_scaling as fig8  # noqa: E402
from benchmarks import torch_fig_market as market  # noqa: E402
from benchmarks import torch_fig_stream as stream  # noqa: E402
from benchmarks import torch_proc_calibration as cal  # noqa: E402
from repro.api import DeadWindow as JDeadWindow  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.api import SimBackend as JSimBackend  # noqa: E402
from repro.api import resize_events as j_resize_events  # noqa: E402
from repro.core import agent as j_agent  # noqa: E402
from repro.core import baselines as j_baselines  # noqa: E402
from repro.core import pretrain as j_pretrain  # noqa: E402
from repro.data import pipeline as j_pipeline  # noqa: E402
from repro.data import simulator as j_simulator  # noqa: E402
from repro_torch.api import (DeadWindow, RELAUNCH_TICKS, Session,  # noqa: E402
                             SimBackend, resize_events)
from repro_torch.core import baselines  # noqa: E402
from repro_torch.data import pipeline, simulator  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The DQN is a few small matmuls a tick: one intra-op thread runs
    them as fast as the host's eight, and leaves the other cores to the
    measurement windows of the tests that xdist runs beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def agents(tmp_path, monkeypatch):
    """Seeded npz agents of 3, 4, 5 and 7 stages in the JAX layout, the
    agent caches and the JSON outputs of both packages in tmp_path.
    Yields the directory; fails if anything else was cached there."""
    names = []
    for n in (3, 4, 5, 7):
        cfg = j_agent.DQNConfig(obs_dim=2 * n + 6, n_stages=n,
                                head="factored")
        j_pretrain.save_agent(j_agent.DQNAgent(cfg, seed=n),
                              str(tmp_path / f"dqn_factored_r{n}.npz"))
        names.append(f"dqn_factored_r{n}.npz")
    out = tmp_path / "bench"
    for mod in (common, torch_common):
        monkeypatch.setattr(mod, "AGENT_DIR", str(tmp_path))
        monkeypatch.setattr(mod, "OUT_DIR", str(out))
    yield tmp_path
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == names


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def _first_diff(got, want):
    """The first index at which two sequences differ (or their shorter
    length if one is a prefix of the other); None if equal."""
    for t, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return t
    return None if len(got) == len(want) else min(len(got), len(want))


def _json(tmp, name):
    return json.loads((tmp / "bench" / name).read_text())


# ------------------------------------------------------------ the cache --
@pytest.mark.parametrize("name", ["dqn_factored_r5.npz", "dqn_factored_r5"])
def test_save_agent_replaces_the_cache_whole(name, tmp_path):
    """The port's save_agent writes beside the target and renames over
    it (a process loading the cache never reads a half-written file):
    no temporary file is left, a name without .npz gets it as np.savez
    gives it, and an existing file is replaced by one the reference's
    loader reads back bitwise."""
    from repro_torch.core import agent, pretrain
    cfg = agent.DQNConfig(obs_dim=16, n_stages=5, head="factored")
    (tmp_path / "dqn_factored_r5.npz").write_bytes(b"stale")
    pretrain.save_agent(agent.DQNAgent(cfg, seed=5), str(tmp_path / name))
    assert [p.name for p in tmp_path.iterdir()] == ["dqn_factored_r5.npz"]
    got = j_pretrain.load_agent_state(str(tmp_path / "dqn_factored_r5.npz"))
    want = agent.DQNAgent(cfg, seed=5).state_dict()
    assert got["steps"] == want["steps"]
    for layer, p in want["qnet"].items():
        for k, v in p.items():
            assert np.array_equal(got["qnet"][layer][k], v), (layer, k)


# ------------------------------------------------------- ReadaptPolicy ---
class _Logged:
    """Records the workers of every allocation the wrapped policy
    proposes."""

    def __init__(self, opt):
        self.opt, self.name, self.log = opt, opt.name, []

    def propose(self, *a):
        alloc = self.opt.propose(*a)
        self.log.append(alloc.workers.tolist())
        return alloc

    def observe(self, tel):
        self.opt.observe(tel)


@pytest.mark.parametrize("readapt", [False, True])
def test_readapt_policy_is_the_references(readapt):
    """The *-Adaptive protocol of tests/test_api_session.py (a resize at
    ticks 0 and 20, a relaunch window at each): the port's ReadaptPolicy
    proposes the reference's allocation at every tick and the Session
    runs give the same trace bit for bit; without `readapt` it is
    FrozenPolicy."""
    spec, jspec = pipeline.criteo_pipeline(), j_pipeline.criteo_pipeline()
    machine = simulator.MachineSpec(n_cpus=64, mem_mb=65536.0)
    jmachine = j_simulator.MachineSpec(n_cpus=64, mem_mb=65536.0)
    resizes = [(0, 64), (20, 32)]
    runs = []
    for pol, b, s, m, ev, dw, sess, be in (
            (torch_common.ReadaptPolicy, baselines, spec, machine,
             resize_events, DeadWindow, Session, SimBackend),
            (common.ReadaptPolicy, j_baselines, jspec, jmachine,
             j_resize_events, JDeadWindow, JSession, JSimBackend)):
        fn = (lambda s_, m_, seed, b=b: b.heuristic_even(s_, m_)) \
            if readapt else None
        opt = _Logged(pol(b.heuristic_even(s, m), fn, seed=0,
                          resize_ticks=[t for t, _ in resizes]))
        events = ev(resizes) + ([dw(t, RELAUNCH_TICKS) for t, _ in resizes]
                                if readapt else [])
        res = sess(be(s, m, seed=0), opt).run(50, events=events)
        runs.append((opt.log, res))
    (log, res), (jlog, jres) = runs
    assert log == jlog and len(log) > 0
    for k in ("throughput", "used_cpus", "mem_mb", "oom_count"):
        assert res[k] == jres[k], k
    assert torch_common.ReadaptPolicy.name == common.ReadaptPolicy.name
    assert "ReadaptPolicy" in torch_common.__all__


# ----------------------------------------------------------------- fig5 --
@pytest.mark.parametrize("name", ["criteo", "custom", "multisource"])
def test_fig5_rows_match_the_reference(name, agents):
    """Every row (the static baselines over 5 seeds, and InTune's steady
    state over 400 ticks: ControllerBackend on the linear chains, the
    Session's SimBackend on the multi-source DAG) bitwise, and each
    package's JSON written under its OUT_DIR."""
    got = fig5.run(name, ticks=400, seeds=5, quiet=True)
    want = j_fig5.run(name, ticks=400, seeds=5, quiet=True)
    assert list(got) == list(want)
    assert got == want
    assert _json(agents, f"torch_fig5_{name}.json") == \
        _json(agents, f"fig5_{name}.json")


# ----------------------------------------------------------------- fig7 --
@pytest.mark.parametrize("name", ["criteo", "custom"])
def test_fig7_timelines_match_the_reference(name, agents):
    """450 ticks of the 32 -> 64 -> 128 -> 64 -> 32 rescale: every
    policy's throughput timeline tick for tick (the *-Adaptive ones with
    their relaunch windows, frozen AUTOTUNE, the tuner at finetune 150)
    and the summary with its speedups, bitwise."""
    got = fig7.run(name, ticks=450, quiet=True)
    want = j_fig7.run(name, ticks=450, quiet=True)
    tl = _json(agents, f"torch_fig7_{name}.json")["timelines"]
    jtl = _json(agents, f"fig7_{name}.json")["timelines"]
    assert list(tl) == list(jtl)
    for policy in jtl:
        t = _first_diff(tl[policy], jtl[policy])
        assert t is None, f"{policy}: first differing tick {t}"
    assert got == want


# ----------------------------------------------------------------- fig8 --
def test_fig8_panels_match_the_reference(agents, monkeypatch):
    """The three panels (complexity with the 3-, 4- and 5-stage agents,
    CPUs 8-128, batch x0.25-x4) through the reference's own knobs at a
    reduced size: InTune's steady state over 60 ticks, AUTOTUNE's mean
    over 3 seeds; every number bitwise."""
    for mod in (fig8, j_fig8):
        monkeypatch.setattr(mod, "_intune_steady", functools.partial(
            mod._intune_steady, ticks=60))
        monkeypatch.setattr(mod, "_autotune_mean", functools.partial(
            mod._autotune_mean, seeds=3))
    got = fig8.run(quiet=True)
    want = j_fig8.run(quiet=True)
    assert [r["stages"] for r in got["complexity"]] == [3, 4, 5]
    assert got == want
    assert _json(agents, "torch_fig8_scaling.json") == \
        _json(agents, "fig8_scaling.json")


def test_fig8_pipelines_are_the_references():
    for n, udf in [(3, False), (4, False), (5, True), (5, False)]:
        got = fig8._pipeline_of_complexity(n, with_udf=udf, batch_mb=64.0)
        want = j_fig8._pipeline_of_complexity(n, with_udf=udf,
                                              batch_mb=64.0)
        assert [s.__dict__ for s in got.stages] == \
            [s.__dict__ for s in want.stages]
        assert (got.name, got.batch_mb, got.target_rate) == \
            (want.name, want.batch_mb, want.target_rate)


# --------------------------------------------------------------- market --
def test_market_summary_matches_the_reference(agents):
    """The multi-job market on 16 machines of big_cluster (churn scaled
    to the run) over 80 ticks: the five policies' summaries (mean and steady
    throughput, OOMs, per-job throughput, share of the oracle) and the
    speedups bitwise; the market arm is PoolMarket over per-job
    coordinators from the shared npz (make_pool_market)."""
    got = market.run(ticks=80, n_machines=16, quiet=True)
    want = j_market.run(ticks=80, n_machines=16, quiet=True)
    assert list(got) == list(want)
    assert got == want


def test_market_proc_arm_holds_its_invariants(agents):
    """The proc arm on real processes (ProcFleet over the 3-trainer,
    2-job proc_market): no OOM and no dropped batch in either arm, every
    process joined and none left running, and the reference's summary
    keys (benchmarks/fig_market.py's run_proc). Rates are measured and
    are not compared."""
    before = set(mp.active_children())
    got = market.run_proc(ticks=8, window_s=0.1, quiet=True)
    assert set(mp.active_children()) <= before
    assert list(got) == ["fleet_even", "market", "_speedups"]
    for name in ("fleet_even", "market"):
        s = got[name]
        assert list(s) == ["mean_tput", "oom_count", "dropped_batches",
                           "all_joined"]
        assert s["oom_count"] == 0 and s["dropped_batches"] == 0, s
        assert s["all_joined"] is True
        assert s["mean_tput"] > 0.0
    assert math.isfinite(got["_speedups"]["market_vs_even"])
    assert dataclasses.asdict(market.proc_market()) == \
        dataclasses.asdict(j_market.proc_market())


# --------------------------------------------------------------- stream --
def _rows_of(mod, fn, *a):
    """(per-arm rows, result) of fn(*a) with `mod.run_arm` recording."""
    rows = []
    orig = mod.run_arm

    def recording(*args, **kw):
        r, res = orig(*args, **kw)
        rows.append(r)
        return r, res
    mod.run_arm = recording
    try:
        return rows, _quiet(fn, *a)
    finally:
        mod.run_arm = orig


def test_stream_sim_arm_matches_the_reference_row_for_row(agents,
                                                          monkeypatch):
    """fig_stream's sim arm (the flash crowd at its full 600 ticks, the
    three arms): the reference's run_sim(seed=0) twice from the shared
    npz gives the same rows, and the port's `main --quick` gives them
    too, row for row, with the same scores, bars and payload."""
    want_rows, want = _rows_of(j_stream, j_stream.run_sim, 0)
    again_rows, again = _rows_of(j_stream, j_stream.run_sim, 0)
    assert again_rows == want_rows and again == want
    monkeypatch.setattr("sys.argv", ["torch_fig_stream", "--quick",
                                     "--no-assert"])
    rows, rc = _rows_of(stream, stream.main)
    assert [len(r) for r in rows] == [stream.SIM_TICKS] * 3
    for arm, (r, w) in enumerate(zip(rows, want_rows)):
        t = _first_diff(r, w)
        assert t is None, f"arm {arm}: first differing tick {t}"
    payload = _json(agents, "BENCH_torch_stream.json")
    assert list(payload) == ["sim"]
    assert payload["sim"] == json.loads(json.dumps(want, default=float))
    assert rc == 0


@pytest.mark.parametrize("case", range(4))
def test_stream_scoring_and_held_tuner_are_the_references(case):
    """score_spike on random rows (both behind rules, runs of 3 and 5)
    and HeldTuner's propose / observe schedule against the reference's."""
    rng = np.random.RandomState(case)
    rows = [{"in_spike": bool(rng.rand() < 0.7),
             "tput": float(rng.rand() * 4), "arr": float(rng.rand() * 4),
             "bl_delta": None if rng.rand() < 0.1 else float(
                 rng.randn() * 2)} for _ in range(80)]
    for behind, jbehind in ((stream.sim_behind, j_stream.sim_behind),
                            (stream.proc_behind, j_stream.proc_behind)):
        for k in (3, 5):
            assert stream.score_spike(rows, behind=behind, consecutive=k) \
                == j_stream.score_spike(rows, behind=jbehind, consecutive=k)

    class Inner:
        def __init__(self):
            self.calls = []

        def propose(self, spec, machine, stats=None):
            self.calls.append(("propose", stats))
            return len(self.calls)

        def observe(self, tel):
            self.calls.append(("observe", tel))

    logs = []
    for mod in (stream, j_stream):
        inner = Inner()
        held = mod.HeldTuner(inner, hold=case + 1)
        out = []
        for i in range(12):
            out.append(held.propose(None, None, i))
            held.observe(i)
        logs.append((out, inner.calls))
    assert logs[0] == logs[1]


def test_stream_proc_arm_holds_its_invariants(agents, monkeypatch):
    """The proc arm on real processes at a reduced size (4 windows of
    0.25 s an arm, so the wall-clock spike does not land, on a declared
    machine of 5 CPUs, so that the frozen arms place 5 spinning workers
    and not the 25 the scenario's machine takes, which would starve the
    measurements of other tests on the host): no OOM in the tuned arm
    (the reference's bar), every process joined and none left running,
    and each arm's summary exactly the reference's `summarize` of the
    same rows; the payload's keys are the reference's."""
    monkeypatch.setattr(stream, "PROC_TICKS", 4)
    monkeypatch.setattr(stream, "PROC_WINDOW_S", 0.25)
    scenario = stream.proc_scenario
    monkeypatch.setattr(stream, "proc_scenario", lambda: (
        scenario()[0], simulator.MachineSpec(n_cpus=5, mem_mb=16384.0)))
    before = set(mp.active_children())
    runs = []
    orig = stream.run_arm

    def recording(backend, opt, ticks, *, spike_rate):
        rows, res = orig(backend, opt, ticks, spike_rate=spike_rate)
        # the Session closed the backend: its cached teardown accounting
        runs.append((rows, res, backend.shutdown()))
        return rows, res
    monkeypatch.setattr(stream, "run_arm", recording)
    got = _quiet(stream.run_proc, 0)
    assert set(mp.active_children()) <= before
    assert list(got) == ["scenario", "arms", "readapt_bar_ticks", "pass"]
    assert list(got["arms"]) == ["even", "static_best", "intune"]
    assert list(got["pass"]) == ["frozen_arms_starve", "intune_readapts",
                                 "intune_no_oom"]
    assert got["arms"]["intune"]["oom_count"] == 0
    assert got["pass"]["intune_no_oom"] is True
    for (rows, res, acct), (label, arm) in zip(runs, got["arms"].items()):
        assert len(rows) == 4
        want = _quiet(j_stream.summarize, label, rows, res,
                      behind=j_stream.proc_behind, consecutive=3)
        assert arm == want
        assert acct["all_joined"] is True, (label, acct)


def test_proc_calibration_at_one_rep_holds_its_invariants(agents,
                                                          monkeypatch):
    """run() with one repetition of the measured rankings and a short
    calibration sweep (1 and 2 workers, windows of 0.6 s after the
    calibrator's 0.5 s settle: the demo's 0.12 s stage fills a few
    batches a window even on a busy host): the reference's payload keys, the reference's
    candidates and its designed-spec predictions bitwise, every fitted
    cost and measured rate finite and positive, no process left
    running, and the JSON written."""
    orig_cal = cal.calibrate_stagegraph
    monkeypatch.setattr(cal, "calibrate_stagegraph", lambda spec, **kw:
                        orig_cal(spec, **dict(kw, workers=(1, 2),
                                              window_s=0.6)))
    monkeypatch.setattr(cal, "measure_rankings", functools.partial(
        cal.measure_rankings, reps=1))
    before = set(mp.active_children())
    got = cal.run(quiet=True)
    assert set(mp.active_children()) <= before
    assert list(got) == ["candidates", "predicted_designed",
                         "predicted_calibrated", "measured_proc",
                         "rank_match_designed", "rank_match_calibrated",
                         "calibration"]
    assert got["candidates"] == [list(w) for w in j_cal.CANDIDATES]
    big = j_simulator.MachineSpec(n_cpus=64, mem_mb=65536.0)
    want = [j_simulator.PipelineSim(j_cal.ranking_pipeline(), big)
            .throughput(j_simulator.Allocation(np.asarray(w)))
            for w in j_cal.CANDIDATES]
    assert got["predicted_designed"] == want
    assert len(got["measured_proc"]) == len(j_cal.CANDIDATES)
    assert all(x > 0.0 and math.isfinite(x) for x in got["measured_proc"])
    assert list(got["calibration"]) == ["src", "feature_udf", "batch"]
    for name, c in got["calibration"].items():
        assert c["designed_cost"] == next(
            s.cost for s in cal.proc_demo_pipeline().stages if s.name == name)
        assert c["fitted_cost"] > 0.0 and math.isfinite(c["fitted_cost"])
        assert 0.0 <= c["fitted_serial_frac"] <= 1.0
    assert _json(agents, "torch_proc_calibration.json")["candidates"] == \
        got["candidates"]
