"""The closed-loop launcher's checkpoints: the port's `checkpoint.save`
keeps `extras` and `restore` takes a `step`, as the reference's do; a
checkpoint written by either launcher's `save_step` resumes in the
other's `restore_or_init` with equal parameters, adagrad state and
tuner state; the port's `run_proc` and `run_sim` resume after the saved
step."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.agent import DQNAgent as JDQNAgent  # noqa: E402
from repro.core.agent import DQNConfig as JDQNConfig  # noqa: E402
from repro.core.controller import InTune as JInTune  # noqa: E402
from repro.data.pipeline import train_feed_pipeline as j_train_feed  # noqa: E402
from repro.data.simulator import Allocation as JAllocation  # noqa: E402
from repro.data.simulator import MachineSpec as JMachine  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs.base import DLRMConfig  # noqa: E402
from repro_torch.core.controller import InTune  # noqa: E402
from repro_torch.data.pipeline import train_feed_pipeline  # noqa: E402
from repro_torch.data.simulator import Allocation, MachineSpec  # noqa: E402
from repro_torch.launch import train_dlrm_criteo as launcher  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="tiny", n_sparse=4, n_dense=13, embed_dim=8,
            vocab_sizes=(64,) * 4, bottom_mlp=(16, 8), top_mlp=(16, 1))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_dlrm_criteo", ROOT / "examples" / "train_dlrm_criteo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _agent_state(seed):
    cfg = JDQNConfig(obs_dim=16, n_stages=5, head="factored")
    st = JDQNAgent(cfg, seed=seed).state_dict()
    return {"qnet": jax.tree_util.tree_map(np.asarray, st["qnet"]),
            "steps": 0}


def _tuner(cls, spec_fn, machine_cls, alloc_cls, seed, ticks):
    """The launcher's tuner (run_proc's arguments) from a pretrained
    state, ticked on its simulator so that the agent has trained and the
    allocation has moved."""
    t = cls(spec_fn(step_time_s=0.05), machine_cls(n_cpus=12, mem_mb=4096),
            seed=seed, head="factored", pretrained=_agent_state(seed),
            finetune_ticks=30, lcb_coef=0.15, switch_margin=0.05,
            init_alloc=alloc_cls(np.ones(5, dtype=int), prefetch_mb=32.0))
    for _ in range(ticks):
        t.tick()
    return t


def _tuner_state(t) -> dict:
    st = t.state_dict()
    qnet = {f"{layer}/{k}": np.asarray(v) for layer, p in
            st["agent"]["qnet"].items() for k, v in p.items()}
    return {"qnet": qnet, "steps": int(st["agent"]["steps"]),
            "workers": [int(w) for w in st["workers"]],
            "prefetch_mb": float(st["prefetch_mb"])}


def _assert_same_tuner(a, b):
    sa, sb = _tuner_state(a), _tuner_state(b)
    assert sa["qnet"].keys() == sb["qnet"].keys()
    for k in sa["qnet"]:
        assert sa["qnet"][k].dtype == sb["qnet"][k].dtype, k
        np.testing.assert_array_equal(sa["qnet"][k], sb["qnet"][k],
                                      err_msg=k)
    assert (sa["steps"], sa["workers"], sa["prefetch_mb"]) == \
        (sb["steps"], sb["workers"], sb["prefetch_mb"])


def _assert_same_tree(got, want):
    got = {k: np.asarray(v) for k, v in ckpt._flatten(got).items()}
    want = {k: np.asarray(v) for k, v in jckpt._flatten(want).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_tree(model, opt_state):
    named = {k: p.detach() for k, p in model.named_parameters()}
    return {"params": dlrm.tree_from_named(named),
            "opt_state": {k: dlrm.tree_from_named(v)
                          for k, v in opt_state.items()}}


def _jax_state():
    jcfg = _jax_example().DLRMConfig(**TINY)
    params, _ = jdlrm.init_params(jax.random.PRNGKey(0), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(1)
    state = joptim.make_optimizer("adagrad", lr=0.02).init(params)
    state = jax.tree_util.tree_map(
        lambda x: rng.rand(*x.shape).astype(np.float32), state)
    return params, state


def _port_state(seed):
    model = dlrm.init_params(DLRMConfig(**TINY), seed=seed, device="cpu")
    opt = optim.make_optimizer("adagrad", lr=0.02)
    state = opt.init(dict(model.named_parameters()))
    rng = np.random.RandomState(seed)
    for a in state["acc"].values():
        a.copy_(torch.from_numpy(rng.rand(*a.shape).astype(np.float32)))
    return model, state


# ---------------------------------------------------------- checkpoint ----
def test_save_keeps_extras_and_restore_takes_a_step(tmp_path):
    d = str(tmp_path)
    extras = {"intune": {"workers": [2, 1, 1, 7, 1], "prefetch_mb": 64.0,
                         "agent_steps": 12}}
    for step in (3, 7):
        ckpt.save(d, step, {"x": torch.full((4, 3), float(step)),
                            "q": {"l1": {"w": np.ones((2, 2)) * step}}},
                  extras=dict(extras, at=step), max_shard_bytes=16)
    tree, manifest = ckpt.restore(d, "cpu", step=3)
    assert manifest["step"] == 3 and manifest["extras"]["at"] == 3
    assert manifest["extras"]["intune"] == extras["intune"]
    assert torch.equal(tree["x"], torch.full((4, 3), 3.0))
    assert torch.equal(tree["q"]["l1"]["w"], torch.full((2, 2), 3.0,
                                                        dtype=torch.float64))
    tree, manifest = ckpt.restore(d, "cpu")
    assert manifest["step"] == 7 and float(tree["x"][0, 0]) == 7.0
    # the reference reads both steps of the port's files, extras included
    jtree, jmanifest = jckpt.restore(d, step=3)
    assert jmanifest["extras"] == manifest["extras"] | {"at": 3}
    np.testing.assert_array_equal(jtree["x"], np.full((4, 3), 3.0,
                                                      np.float32))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), "cpu")


def test_save_writes_empty_extras_by_default(tmp_path):
    ckpt.save(str(tmp_path), 0, {"x": torch.zeros(2)})
    assert ckpt.restore(str(tmp_path), "cpu")[1]["extras"] == {}
    assert jckpt.restore(str(tmp_path))[1]["extras"] == {}


# ------------------------------------------------------------ launchers ---
def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX example's `save_step` -> the port's `restore_or_init`:
    parameters, adagrad state and tuner state equal, resumed after the
    saved step."""
    jex = _jax_example()
    params, state = _jax_state()
    jtuner = _tuner(JInTune, j_train_feed, JMachine, JAllocation, 0, 40)
    assert _tuner_state(jtuner)["steps"] > 0
    jex.save_step(str(tmp_path), 5, params, state, jtuner)

    model, opt_state = _port_state(seed=3)
    tuner = _tuner(InTune, train_feed_pipeline, MachineSpec, Allocation, 1, 0)
    start, model, opt_state = launcher.restore_or_init(
        str(tmp_path), model, opt_state, tuner)
    assert start == 6
    _assert_same_tree(_port_tree(model, opt_state),
                      {"params": params, "opt_state": state})
    _assert_same_tuner(tuner, jtuner)


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    """The port's `save_step` -> the JAX example's `restore_or_init`."""
    jex = _jax_example()
    model, opt_state = _port_state(seed=3)
    tuner = _tuner(InTune, train_feed_pipeline, MachineSpec, Allocation, 0, 40)
    assert _tuner_state(tuner)["steps"] > 0
    launcher.save_step(str(tmp_path), 8, model, opt_state, tuner)

    params, state = _jax_state()
    jtuner = _tuner(JInTune, j_train_feed, JMachine, JAllocation, 1, 0)
    start, params, state = jex.restore_or_init(str(tmp_path), params, state,
                                               jtuner)
    assert start == 9
    _assert_same_tree(_port_tree(model, opt_state),
                      {"params": params, "opt_state": state})
    _assert_same_tuner(tuner, jtuner)


def test_run_proc_checkpoints_and_resumes(tmp_path):
    """run_proc saves at its last step; a second run_proc with the same
    directory and no step left restores the first's parameters, adagrad
    state and tuner bitwise; without a directory nothing is written."""
    cfg = DLRMConfig(**TINY)
    kw = dict(batch=32, tune_every=2, finetune_ticks=90, device="cpu",
              seed=0, ckpt_dir=str(tmp_path), ckpt_every=3)
    first = launcher.run_proc(SimpleNamespace(steps=4, **kw), cfg)
    assert first["start"] == 0 and len(first["losses"]) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000003"]
    again = launcher.run_proc(SimpleNamespace(steps=4, **kw), cfg)
    assert again["start"] == 4 and again["losses"] == []
    assert again["loop_step_s"] is None
    named = dict(again["model"].named_parameters())
    for k, p in first["model"].named_parameters():
        assert torch.equal(p, named[k]), k
    for k, a in first["opt_state"]["acc"].items():
        assert torch.equal(a, again["opt_state"]["acc"][k]), k
    _assert_same_tuner(first["tuner"], again["tuner"])
    for w in first["windows"]:
        assert 0.0 <= w["idle"] <= 1.0 and w["batches"] > 0
        assert w["idle"] < 1.0 or min(w["batches"], w["produced"]) <= 0


def test_run_sim_resumes_after_the_saved_step(tmp_path):
    cfg = DLRMConfig(**TINY)
    kw = dict(batch=16, device="cpu", seed=0, ckpt_dir=str(tmp_path),
              ckpt_every=0)
    first = launcher.run_sim(SimpleNamespace(steps=3, **kw), cfg)
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000002"]
    on = launcher.run_sim(SimpleNamespace(steps=5, **kw), cfg)
    assert on["start"] == 3 and len(on["losses"]) == 2
    assert all(np.isfinite(on["losses"]))
    assert len(on["allocations"]) == 2
    assert first["start"] == 0 and len(first["losses"]) == 3


def test_launcher_cli_takes_the_checkpoint_flags(monkeypatch):
    seen = []
    monkeypatch.setattr(launcher, "run_proc", lambda args: seen.append(
        (args.ckpt_dir, args.ckpt_every)))
    launcher.main(["--steps", "3", "--ckpt-dir", "d", "--ckpt-every", "7"])
    launcher.main(["--steps", "3"])
    assert seen == [("d", 7), (None, 100)]
