"""The closed loop's scorer on the port: `FrozenPolicy` and the runtime
constants are the reference's, `benchmarks/torch_common.make_tuner`
proposes bitwise what `benchmarks/common.make_tuner` does from the same
npz, `benchmarks/torch_fig_train_feed` runs the reference's three arms
with the reference's arguments and payload, and the accounting that
makes the closed loop's tail windows read idle 1.0 is the reference's."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.api as japi  # noqa: E402
from benchmarks import common  # noqa: E402
from benchmarks import fig_train_feed as jfig  # noqa: E402
from benchmarks import torch_common  # noqa: E402
from benchmarks import torch_fig_train_feed as tfig  # noqa: E402
from repro.api.constants import OOM_RESTART_TICKS as J_OOM_TICKS  # noqa: E402
from repro.api.constants import RELAUNCH_TICKS as J_RELAUNCH  # noqa: E402
from repro.configs.base import DLRMConfig as JDLRMConfig  # noqa: E402
from repro.data import device_feed as jfeed  # noqa: E402
from repro.data import featurize as jfeat  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import proc_executor as jproc  # noqa: E402
from repro.data import simulator as jsim  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.train.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.train.train_step import make_train_step as j_make_step  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import constants  # noqa: E402
from repro_torch.configs.base import DLRMConfig  # noqa: E402
from repro_torch.core.pretrain import pretrain, save_agent  # noqa: E402
from repro_torch.data import device_feed, featurize, pipeline  # noqa: E402
from repro_torch.data import proc_executor, simulator  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="tiny", n_sparse=4, n_dense=13, embed_dim=8,
            vocab_sizes=(64,) * 4, bottom_mlp=(16, 8), top_mlp=(16, 1))


def test_frozen_policy_and_constants_are_the_reference_ones():
    assert constants.RELAUNCH_TICKS == J_RELAUNCH == 20
    assert constants.OOM_RESTART_TICKS == J_OOM_TICKS == 30
    assert api.RELAUNCH_TICKS == japi.RELAUNCH_TICKS
    assert api.OOM_RESTART_TICKS == japi.OOM_RESTART_TICKS
    assert torch_common.RELAUNCH_TICKS == common.RELAUNCH_TICKS
    alloc = simulator.Allocation(np.array([2, 1, 1, 7, 1]), 32.0)
    port, ref = api.FrozenPolicy(alloc), japi.FrozenPolicy(alloc)
    assert port.name == ref.name == "frozen"
    for policy in (port, ref):
        assert policy.propose(None, None, {"workers": [9] * 5}) is alloc
        assert policy.observe(None) is None
        assert policy.propose(None, None) is alloc


@pytest.fixture
def shared_agents(tmp_path, monkeypatch):
    """One pretrained 5-stage agent npz, the cache of both packages'
    benchmark helpers (a short pretraining: the weights, not their
    quality, are what the packages share)."""
    save_agent(pretrain(5, episodes=1, ticks=30, verbose=False,
                        head="factored"),
               str(tmp_path / "dqn_factored_r5.npz"))
    monkeypatch.setattr(common, "AGENT_DIR", str(tmp_path))
    monkeypatch.setattr(torch_common, "AGENT_DIR", str(tmp_path))
    return tmp_path


def test_agent_cache_lives_in_the_checkout_build_dir():
    build = ROOT / "build"
    assert Path(torch_common.AGENT_DIR).resolve() == build / "agents"
    assert Path(torch_common.OUT_DIR).resolve() == build / "bench"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_get_agent_state_loads_the_cached_npz(shared_agents):
    got = torch_common.get_agent_state(5)
    want = common.get_agent_state(5)
    assert got["steps"] == want["steps"]
    assert got["qnet"].keys() == want["qnet"].keys()
    for layer in want["qnet"]:
        for k in want["qnet"][layer]:
            np.testing.assert_array_equal(got["qnet"][layer][k],
                                          want["qnet"][layer][k])
    assert sorted(os.listdir(shared_agents)) == ["dqn_factored_r5.npz"]


def test_make_tuner_proposes_the_reference_allocations(shared_agents):
    """From the same npz, the intune arm's tuner of each package, fed one
    sequence of feed telemetry (live stats and device_idle_frac), proposes
    the same allocations, bit for bit, through exploration, restarts and
    serving."""
    kw = dict(seed=0, finetune_ticks=20, explore_restart_every=12,
              lcb_coef=0.15, switch_margin=0.05)
    jspec = jpipeline.train_feed_pipeline(step_time_s=0.08, work="real")
    spec = pipeline.train_feed_pipeline(step_time_s=0.08, work="real")
    jm, m = (jsim.MachineSpec(n_cpus=30, mem_mb=4096),
             simulator.MachineSpec(n_cpus=30, mem_mb=4096))
    ref = common.make_tuner(jspec, jm, init_alloc=jsim.Allocation(
        np.ones(5, dtype=int), 2.0 * jspec.batch_mb), **kw)
    port = torch_common.make_tuner(spec, m, init_alloc=simulator.Allocation(
        np.ones(5, dtype=int), 2.0 * spec.batch_mb), **kw)
    rng = np.random.RandomState(4)
    workers = [1] * 5
    for tick in range(40):
        stats = {"stage_latency": list(rng.uniform(0.01, 0.5, 5)),
                 "workers": workers, "prefetch_mb": 16.0,
                 "free_cpus": max(0, 30 - sum(workers)),
                 "mem_frac": float(rng.uniform(0.05, 0.3))}
        a, b = ref.propose(jspec, jm, stats), port.propose(spec, m, stats)
        assert list(map(int, a.workers)) == list(map(int, b.workers)), tick
        assert float(a.prefetch_mb) == float(b.prefetch_mb), tick
        workers = list(map(int, b.workers))
        idle = float(rng.uniform(0.1, 0.9))
        ref.observe(japi.Telemetry(3.0, 100.0, sum(workers), False, False,
                                   dict(stats), device_idle_frac=idle,
                                   step_time_s=0.1))
        port.observe(api.Telemetry(3.0, 100.0, sum(workers), False, False,
                                   dict(stats), device_idle_frac=idle,
                                   step_time_s=0.1))
    assert [h["reward"] for h in port.history] == \
        [h["reward"] for h in ref.history]


def _reference_row_keys(rec, machine):
    jcfg = JDLRMConfig(**TINY)
    params, _ = jdlrm.init_params(jax.random.PRNGKey(0), jcfg)
    opt = j_make_optimizer("adagrad", lr=0.02)
    step_fn = jax.jit(j_make_step(lambda p, b: jdlrm.loss_fn(p, jcfg, b),
                                  opt))
    row = jfig.run_arm(
        "static_best", lambda s, mm: japi.FrozenPolicy(jsim.Allocation(
            np.ones(s.n_stages, dtype=int), 2.0 * s.batch_mb)),
        step_fn=step_fn, params=params, opt_state=opt.init(params),
        rec=jfeat.RecordSpec(**rec),
        spec=jpipeline.train_feed_pipeline(step_time_s=0.02, work="real"),
        machine=jsim.MachineSpec(**machine), steps=12, tune_every=2,
        step_time=0.02, warm_steps=4)
    return set(row), row["workers_final"]


def test_run_arm_gives_the_reference_row_and_frozen_arms_hold():
    """The port's run_arm at a tiny DLRM on the CPU, 12 steps (4 warm):
    the reference's row keys; each frozen arm ends at its allocation,
    from freshly seeded weights, losses finite."""
    rec = dict(batch=32, n_sparse=4, n_dense=13, vocab=64)
    machine = dict(n_cpus=10, mem_mb=4096)
    want_keys, want_static = _reference_row_keys(rec, machine)
    cfg = DLRMConfig(**TINY)
    spec = pipeline.train_feed_pipeline(step_time_s=0.02, work="real")
    m = simulator.MachineSpec(**machine)
    even = tfig.heuristic_even(spec, m)
    assert list(even.workers) == [2] * 5
    arms = {"static_best": simulator.Allocation(np.ones(5, dtype=int),
                                                2.0 * spec.batch_mb),
            "even": even}
    for name, alloc in arms.items():
        model, opt_state, step_fn = tfig.build_model(
            cfg, seed=0, device=torch.device("cpu"))
        losses = []
        row = tfig.run_arm(
            name, lambda s, mm: api.FrozenPolicy(alloc), step_fn=step_fn,
            model=model, opt_state=opt_state,
            rec=featurize.RecordSpec(**rec), spec=spec, machine=m, steps=12,
            tune_every=2, step_time=0.02, device=torch.device("cpu"),
            warm_steps=4, losses=losses)
        assert set(row) == want_keys
        assert row["arm"] == name and row["ticks"] >= 1
        assert row["workers_final"] == list(map(int, alloc.workers))
        assert len(row["idle_series"]) == row["ticks"]
        assert row["teardown"]["all_joined"] is True
        assert len(losses) == 12
        assert bool(torch.isfinite(torch.stack(losses)).all())
    assert want_static == [1] * 5


def _main_calls(mod, make_tuner_owner, argv, monkeypatch):
    """Runs a train-feed main with the model, timing and arms replaced:
    returns (the run_arm calls, the make_tuner kwargs, the payload)."""
    calls, tuner_kw, saved = [], [], {}

    def run_arm(name, make_opt, **kw):
        spec, machine = kw["spec"], kw["machine"]
        calls.append((name, make_opt(spec, machine),
                      {k: kw[k] for k in ("steps", "tune_every",
                                          "step_time", "warm_steps")},
                      (spec.name, machine.n_cpus, machine.mem_mb)))
        return {"arm": name, "idle_frac": {"even": 0.8, "intune": 0.5,
                                           "static_best": 0.6}[name],
                "step_time_s": 0.2, "idle_series": [], "workers_final": None,
                "ticks": 0, "teardown": {}}

    def make_tuner(spec, machine, **kw):
        kw = dict(kw, init_alloc=(list(map(int, kw["init_alloc"].workers)),
                                  float(kw["init_alloc"].prefetch_mb)))
        tuner_kw.append(kw)
        return "tuner"

    monkeypatch.setattr(mod, "run_arm", run_arm)
    monkeypatch.setattr(make_tuner_owner, "make_tuner", make_tuner)
    monkeypatch.setattr(make_tuner_owner, "save_json",
                        lambda name, payload: saved.update({name: payload}))
    monkeypatch.setattr(mod, "measure_step_time", lambda *a, **k: 0.1)
    if mod is jfig:
        monkeypatch.setattr(mod, "build_model",
                            lambda batch: (JDLRMConfig(**TINY), None, None,
                                           None))
    else:
        monkeypatch.setattr(mod, "build_model",
                            lambda cfg, **kw: (None, None, None))
    mod.main(argv)
    (name, payload), = saved.items()
    return calls, tuner_kw, name, payload


def test_main_runs_the_reference_arms_and_payload(monkeypatch):
    """The same three arms in the same order, with the same frozen
    allocations, the same make_tuner arguments, the same run_arm budget
    (80 smoke steps, 16 warm, tune every 2) and the reference's payload
    keys, plus the model and the device."""
    jcalls, jtuner, jname, jpay = _main_calls(jfig, common, ["--smoke"],
                                              monkeypatch)
    calls, tuner, name, pay = _main_calls(
        tfig, torch_common, ["--smoke", "--device", "cpu"], monkeypatch)
    assert (jname, name) == ("BENCH_train_feed.json",
                             "BENCH_torch_train_feed.json")
    assert [c[0] for c in calls] == [c[0] for c in jcalls] == \
        ["even", "static_best", "intune"]
    for (n, opt, kw, machine), (_, jopt, jkw, jmachine) in zip(calls, jcalls):
        assert kw == jkw and kw["steps"] == 80 and kw["warm_steps"] == 16
        assert machine == jmachine
        if n == "intune":
            assert opt == jopt == "tuner"
        else:
            assert type(opt).__name__ == type(jopt).__name__ == \
                "FrozenPolicy"
            assert list(opt.alloc.workers) == list(jopt.alloc.workers)
            assert opt.alloc.prefetch_mb == jopt.alloc.prefetch_mb
    assert tuner == jtuner and tuner[0]["finetune_ticks"] == 12
    assert set(pay) == set(jpay) | {"model", "device"}
    assert (pay["model"], pay["device"]) == ("dlrm-feed-demo", "cpu")
    for k in ("idle_reduction_vs_even", "step_time_reduction_vs_even",
              "pass_20pct_bar", "steps", "batch", "smoke"):
        assert pay[k] == jpay[k], k


def test_main_takes_the_model_by_name():
    assert tfig.MODELS["dlrm-criteo-1m"].vocab_sizes == (1 << 20,) * 26
    demo = tfig.MODELS["dlrm-feed-demo"]
    assert (demo.n_sparse, demo.vocab_sizes[0], demo.embed_dim,
            demo.bottom_mlp, demo.top_mlp) == (8, 1 << 14, 64, (128, 64),
                                               (256, 128, 1))
    with pytest.raises(SystemExit):
        tfig.main(["--model", "dlrm-criteo"])


def _drain_window(proc_mod, feat_mod, pipe_mod, sim_mod, backend_cls,
                  make_feed):
    """A pipe held at the served allocation [2, 1, 1, 7, 1] fills its
    output queue to a prefetch depth of 8; the prefetch budget is cut to
    one batch, and the train loop takes 3 batches from the inventory.
    Returns the window's Telemetry and the pipe's output queue."""
    rec = feat_mod.RecordSpec(batch=16, n_sparse=4, n_dense=13, vocab=64)
    spec = pipe_mod.train_feed_pipeline(step_time_s=0.01, work="real")
    pipe = proc_mod.ProcessPipeline(
        spec, fns=feat_mod.featurize_stage_fns(spec, record=rec),
        machine=sim_mod.MachineSpec(n_cpus=12, mem_mb=4096), pin_cpus=1)
    pipe.set_allocation([2, 1, 1, 7, 1], 8 * spec.batch_mb)
    backend = backend_cls(pipe, make_feed(pipe), device_step_s=0.05)
    feed = backend.feed
    try:
        deadline = time.monotonic() + 60
        while pipe.stats()["queue_sizes"][-1] < 8:
            assert time.monotonic() < deadline, "the output queue never filled"
            time.sleep(0.05)
        # open the window only once the pipe is at rest (the sink gated
        # by the full queue, the feed's prefetch buffer full): a batch
        # the sink has put but not yet counted would land in the window
        last, since = None, time.monotonic()
        while True:
            c = pipe.counters()
            now = (c["delivered"], c["consumed"],
                   pipe.stats()["queue_sizes"][-1])
            if now != last:
                last, since = now, time.monotonic()
            elif now[2] >= 8 and time.monotonic() - since >= 0.5:
                break
            assert time.monotonic() < deadline, "the pipe never came to rest"
            time.sleep(0.02)
        backend.measure()                       # open the window
        pipe.set_allocation([2, 1, 1, 7, 1], 1 * spec.batch_mb)
        for _ in range(3):
            next(feed)
        time.sleep(0.5)
        tel = backend.measure()
        return tel, pipe.stats()["queue_sizes"][-1]
    finally:
        backend.shutdown()


def test_the_idle_tail_is_the_references_accounting():
    """Why the closed loop's tail windows read idle 1.0 on the card: a
    FeedBackend window credits device time only for batches the pipe
    DELIVERED in it. After the tuner cuts the prefetch budget below the
    inventory in the pipe's output queue, the sink is gated until the
    queue drains, so a window in which the train loop steps at full
    speed from that inventory delivers nothing and reads 1.0. Both
    packages read it so, at the served allocation."""
    got = {}
    got["port"] = _drain_window(
        proc_executor, featurize, pipeline, simulator, api.FeedBackend,
        lambda p: device_feed.make_train_feed(p, depth=2, device="cpu"))
    got["ref"] = _drain_window(
        jproc, jfeat, jpipeline, jsim, japi.FeedBackend,
        lambda p: jfeed.make_train_feed(p, depth=2))
    for who, (tel, out_q) in got.items():
        ex = tel.extras
        assert (ex["produced"], tel.device_idle_frac) == (0, 1.0), who
        assert ex["settling"] is False, who
        assert tel.step_time_s is not None and out_q >= 1, who
    assert got["port"][0].extras["batches"] == 3


def _held_reference_windows(monkeypatch, tmp_path, steps, batch):
    """The JAX example's run_proc at a tiny DLRM, held by a FrozenPolicy
    at [2, 1, 1, 7, 1]: each window's FeedBackend deltas."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_train_dlrm_criteo", ROOT / "examples" / "train_dlrm_criteo.py")
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    jcfg = JDLRMConfig(**TINY)

    def build_model(b):
        params, _ = jdlrm.init_params(jax.random.PRNGKey(0), jcfg)
        opt = j_make_optimizer("adagrad", lr=0.02)
        return jcfg, params, opt, jax.jit(j_make_step(
            lambda p, bb: jdlrm.loss_fn(p, jcfg, bb), opt))
    windows = []

    class Logged(japi.FeedBackend):
        def measure(self):
            mp, mf = self._mark_pipe, self._mark_feed
            tel = super().measure()
            windows.append({
                "idle": tel.device_idle_frac,
                "produced": self._mark_pipe["delivered"] - mp["delivered"],
                "consumed": self._mark_pipe["consumed"] - mp["consumed"],
                "batches": self._mark_feed["batches"] - mf["batches"],
                "wall_s": self._mark_feed["time"] - mf["time"],
                "settling": tel.extras["settling"],
                "workers": list(tel.extras["workers"]),
                "device_step_s": self.device_step_s})
            return tel
    monkeypatch.setattr(jex, "build_model", build_model)
    monkeypatch.setattr(jex, "InTune", lambda spec, machine, **kw:
                        japi.FrozenPolicy(jsim.Allocation(
                            np.array([2, 1, 1, 7, 1]), 32.0)))
    monkeypatch.setattr(jex, "save_step", lambda *a, **k: None)
    monkeypatch.setattr(japi, "FeedBackend", Logged)
    jex.run_proc(type("Args", (), dict(steps=steps, batch=batch,
                                       tune_every=2, finetune_ticks=90,
                                       ckpt_dir=str(tmp_path),
                                       ckpt_every=0))())
    return windows


def test_both_launchers_held_at_the_served_allocation(monkeypatch,
                                                      tmp_path):
    """Each package's run_proc at a tiny DLRM on the CPU, held by a
    FrozenPolicy at the allocation the tuner served in the card's tail
    windows, [2, 1, 1, 7, 1]: both hold it in every window after the
    launch one, and read each window's idle from the same deltas by the
    same arithmetic, 1 - min(batches, produced) * device step / wall
    (clamped to [0, 1]). The windows are printed (`pytest -s`)."""
    from types import SimpleNamespace

    from repro_torch.launch.train_dlrm_criteo import run_proc
    steps, batch = 16, 64
    got = {"ref": _held_reference_windows(monkeypatch, tmp_path, steps,
                                          batch)}
    res = run_proc(SimpleNamespace(steps=steps, batch=batch, tune_every=2,
                                   finetune_ticks=90, device="cpu", seed=0),
                   DLRMConfig(**TINY), policy=api.FrozenPolicy(
                       simulator.Allocation(np.array([2, 1, 1, 7, 1]), 32.0)))
    got["port"] = [dict(w, device_step_s=res["device_step_s"])
                   for w in res["windows"]]
    for who, windows in got.items():
        assert len(windows) == steps // 2, who
        for i, w in enumerate(windows):
            print(f"held {who} window {i}: " + json.dumps(
                {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in w.items()}))
            if i:
                assert w["workers"] == [2, 1, 1, 7, 1], (who, i)
            busy = min(w["batches"], max(w["produced"], 0.0))
            want = 1.0 - busy * w["device_step_s"] / max(w["wall_s"], 1e-9)
            assert w["idle"] == pytest.approx(min(1.0, max(0.0, want)),
                                              rel=1e-9, abs=1e-12), (who, i)


def test_torch_benchmarks_run_without_jax_or_repro():
    code = ("import json, sys; import benchmarks.torch_fig_train_feed; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro'))))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                      str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
