"""The port's examples on the CPU at reduced ticks, the benchmark
entrypoint and the train-feed replay, against the reference where they
compute the same thing.

The quickstart's part 3 trains its DLRM on the CPU (`device="cpu"`, the
plain versions of the kernels) off the live ThreadedPipeline while the
tuning Session runs in its background thread; its first steps' losses
are held within rtol 1e-5 of the JAX train step's on the same batches
from copied weights. `CriteoStream.shuffle_udf` draws the reference's
permutation from the caller's RandomState, bit for bit. The examples on
real threads and processes are held to invariants (no OOM where the
example bars none, every thread and process joined), never to rates."""
import contextlib
import io
import json
import math
import multiprocessing as mp
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks import common, torch_common  # noqa: E402
from benchmarks import torch_debug_feed_replay as replay  # noqa: E402
from benchmarks import torch_run  # noqa: E402
from examples import fleet_tuning as j_fleet_tuning  # noqa: E402
from examples import torch_fleet_tuning as fleet_tuning  # noqa: E402
from examples import torch_live_fleet as live_fleet  # noqa: E402
from examples import torch_multisource_dlrm as multisource  # noqa: E402
from examples import torch_process_pipeline as process_pipeline  # noqa: E402
from examples import torch_quickstart as quickstart  # noqa: E402
from repro.configs.base import DLRMConfig as JConfig  # noqa: E402
from repro.core import agent as j_agent  # noqa: E402
from repro.core import pretrain as j_pretrain  # noqa: E402
from repro.data import fleet as j_fleet  # noqa: E402
from repro.data.synthetic import CriteoStream as JCriteoStream  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.train.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.data import fleet  # noqa: E402
from repro_torch.data.pipeline import multisource_dlrm_pipeline  # noqa: E402
from repro_torch.data.synthetic import CriteoStream  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The DQN is a few small matmuls a tick: one intra-op thread runs
    them as fast as the host's eight, and leaves the other cores to the
    measurement windows of the tests that xdist runs beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a, **kw)
    return res, out.getvalue()


def _no_leftovers(threads, children, timeout: float = 5.0):
    """No thread or child process started since the snapshots is still
    alive after up to `timeout` seconds."""
    import time
    deadline = time.monotonic() + timeout
    while True:
        extra_t = [t.name for t in threading.enumerate()
                   if t not in threads and t.is_alive()]
        extra_p = [p.pid for p in mp.active_children() if p not in children]
        if not (extra_t or extra_p) or time.monotonic() > deadline:
            assert not extra_t and not extra_p, (extra_t, extra_p)
            return
        time.sleep(0.05)


def _snapshot():
    return set(threading.enumerate()), set(mp.active_children())


# ----------------------------------------------------------- shuffle_udf --
@pytest.mark.parametrize("n", [1, 7, 256])
def test_shuffle_udf_draws_the_references_permutation(n):
    """The same block and a RandomState of the same seed: every array of
    every call permuted bit for bit as the reference permutes it, the
    generators left in the same state."""
    block = CriteoStream(n_sparse=4, n_dense=3, vocab=64, seed=n) \
        .raw_block(n)
    rng, jrng = np.random.RandomState(n), np.random.RandomState(n)
    for _ in range(3):
        got = CriteoStream.shuffle_udf(block, rng)
        want = JCriteoStream.shuffle_udf(block, jrng)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
        block = got
    assert rng.randint(1 << 30) == jrng.randint(1 << 30)
    with pytest.raises(TypeError):
        CriteoStream.shuffle_udf(block)


# ------------------------------------------------------------ quickstart --
def test_quickstart_parts_1_and_2():
    """Part 1 (tune on the analytic simulator) at 80 ticks and part 2
    (the same call on real threads) at 6 windows: throughput above 0, no
    OOM, every worker thread joined and nothing dropped."""
    threads, children = _snapshot()
    one, _ = _quiet(quickstart.part1_one_liner, ticks=80)
    assert one["steady"] > 0.0 and one["autotune"] > 0.0
    assert one["oom_count"] == 0
    two, _ = _quiet(quickstart.part2_live_backend, ticks=6)
    assert two["oom_count"] == 0 and len(two["throughput"]) == 6
    assert two["live"]["all_joined"] is True
    assert two["live"]["dropped_batches"] == 0
    assert max(two["throughput"][2:]) > 0.0
    _no_leftovers(threads, children)


def test_quickstart_part3_trains_like_the_jax_step():
    """Part 3 on the CPU, 8 steps under a Session of 6 windows in its
    background thread: the batches the pipeline delivered, run through
    the JAX train step (adagrad at lr 0.05) from the port's initial
    weights copied to numpy, give every step's loss within rtol 1e-5;
    the tuner moved the pools, the Session's thread and every pipeline
    worker joined, and nothing is left running."""
    threads, children = _snapshot()
    batches = []
    res, log = _quiet(quickstart.part3_drop_in, "cpu", steps=8, ticks=6,
                      record=batches)
    _no_leftovers(threads, children)
    assert res["teardown"]["all_joined"] is True
    assert res["teardown"]["oom_count"] == 0
    assert len({tuple(w) for w in res["workers_seen"]}) > 1, \
        res["workers_seen"]
    assert len(res["workers_seen"]) == 7          # the start and 6 ticks
    assert len(batches) == 8 and all(math.isfinite(x) for x in
                                     res["losses"])
    assert batches[0]["sparse_ids"].shape == (quickstart.QS_BATCH, 8, 1)
    assert "step   0 loss" in log

    cfg = quickstart.QS_CONFIG
    np_params = dlrm.params_to_numpy(
        dlrm.init_params(cfg, seed=0, device="cpu"))
    jcfg = JConfig(name=cfg.name, n_sparse=cfg.n_sparse,
                   n_dense=cfg.n_dense, embed_dim=cfg.embed_dim,
                   vocab_sizes=cfg.vocab_sizes, bottom_mlp=cfg.bottom_mlp,
                   top_mlp=cfg.top_mlp)
    opt = j_make_optimizer("adagrad", lr=0.05)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    state = opt.init(params)
    step = jax.jit(j_make_train_step(
        lambda p, b: jdlrm.loss_fn(p, jcfg, b), opt))
    for i, b in enumerate(batches):
        params, state, m = step(params, state, i,
                                {k: jnp.asarray(v) for k, v in b.items()})
        np.testing.assert_allclose(res["losses"][i], float(m["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")


# ------------------------------------------------------- the other four --
def test_process_pipeline_example_on_real_processes():
    """Part 1 (tune on processes) no OOM and every process joined; part
    2's OOM judge fires exactly when the measured RSS is over the 48 MB
    cap, and a fired judge starts the dead window; part 3's calibration
    fits a positive cost and a serial fraction in [0, 1], and the oracle
    on the calibrated spec places the 8 CPUs. Nothing left running."""
    threads, children = _snapshot()
    one, _ = _quiet(process_pipeline.part1_tune_on_processes)
    assert one["oom_count"] == 0 and one["live"]["all_joined"] is True
    two, _ = _quiet(process_pipeline.part2_measured_oom)
    assert two["oom"] == (two["mem_mb"] > 48.0), two
    if two["oom"]:
        assert two["restarting"] is True
    three, _ = _quiet(process_pipeline.part3_calibration)
    assert three["report"]["cost"] > 0.0
    assert 0.0 <= three["report"]["serial_frac"] <= 1.0
    assert three["best"] == [8] and three["tput"] > 0.0
    _no_leftovers(threads, children)


def test_multisource_example_at_reduced_ticks():
    """The join DAG on real threads delivers all 24 joined batches; the
    RL half (a 2-episode pretrain, 40 ticks) runs through the Session
    without an OOM."""
    spec = multisource_dlrm_pipeline()
    real, log = _quiet(multisource.run_real_executor, spec)
    assert real["batches"] == 24 and "24 joined batches" in log
    rl, _ = _quiet(multisource.run_rl_tuning, spec, ticks=40, episodes=2,
                   pretrain_ticks=40)
    assert rl["oom_count"] == 0
    assert 0.0 < rl["final"] and 0.0 < rl["oracle"]


def test_fleet_tuning_example_prints_the_references_fleet():
    """The cluster and the static fleet policies' grants and throughput
    print as the reference prints them; the coordinator (2-episode
    agents) rides demo_cluster(90)'s join, shrink and leave without an
    OOM."""
    cluster, jcluster = fleet.demo_cluster(90), j_fleet.demo_cluster(90)
    _, got = _quiet(lambda: (fleet_tuning.show_cluster(cluster),
                             fleet_tuning.show_static_policies(cluster)))
    _, want = _quiet(lambda: (j_fleet_tuning.show_cluster(jcluster),
                              j_fleet_tuning.show_static_policies(jcluster)))
    assert got == want and "fleet_oracle" in got
    res, _ = _quiet(fleet_tuning.run_coordinator, cluster, 90, episodes=2,
                    pretrain_ticks=40)
    assert res["oom_count"] == 0 and 0.0 < res["mean"] <= res["oracle"]


def test_live_fleet_example_at_reduced_ticks():
    threads, children = _snapshot()
    acct, log = _quiet(live_fleet.main, ticks=20, window_s=0.1)
    assert acct["oom_count"] == 0 and acct["dropped_batches"] == 0
    assert acct["all_joined"] is True and "tick  10" in log
    _no_leftovers(threads, children)


# ------------------------------------------- entrypoint and the replay --
@pytest.fixture
def agent_cache(tmp_path, monkeypatch):
    """A seeded 5-stage npz in the JAX layout as both packages' agent
    cache, their JSON in tmp_path/bench."""
    cfg = j_agent.DQNConfig(obs_dim=16, n_stages=5, head="factored")
    j_pretrain.save_agent(j_agent.DQNAgent(cfg, seed=5),
                          str(tmp_path / "dqn_factored_r5.npz"))
    for mod in (common, torch_common):
        monkeypatch.setattr(mod, "AGENT_DIR", str(tmp_path))
        monkeypatch.setattr(mod, "OUT_DIR", str(tmp_path / "bench"))
    return tmp_path


def test_torch_run_runs_fig5_into_its_out_dir(agent_cache):
    ran, _ = _quiet(torch_run.main, ["--only", "fig5"])
    assert ran == ["fig5"]
    for name in ("criteo", "custom"):
        rows = json.loads((agent_cache / "bench" /
                           f"torch_fig5_{name}.json").read_text())
        assert list(rows)[-1] == "intune"
    assert sorted(p.name for p in agent_cache.glob("*.npz")) == \
        ["dqn_factored_r5.npz"]


@pytest.mark.parametrize("only", ["roofline", "kernels"])
def test_torch_run_names_the_roadmap_item_of_what_is_not_ported(only):
    with pytest.raises(KeyError, match="ROADMAP queue 1, item 7"):
        torch_run.main(["--only", only])


def test_debug_feed_replay_on_the_cpu(agent_cache):
    """The replay on the CPU at 20 steps (the demo DLRM off a real
    featurizing ProcessPipeline, tuned from the cached npz): every loss
    finite, the feed's processes joined and none left running."""
    threads, children = _snapshot()
    res, log = _quiet(replay.main, ["--device", "cpu", "--steps", "20"])
    _no_leftovers(threads, children)
    assert len(res["losses"]) == 20
    assert all(math.isfinite(x) for x in res["losses"])
    assert res["teardown"]["all_joined"] is True
    assert "WARM" in log and "teardown:" in log
