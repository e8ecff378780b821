"""repro_torch's DQN and InTune controller against the JAX package, from
the same weights (carried as numpy) and the same seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import agent as jagent  # noqa: E402
from repro.core.controller import InTune as JInTune  # noqa: E402
from repro.data.pipeline import train_feed_pipeline as j_train_feed  # noqa: E402
from repro.data.simulator import MachineSpec as JMachine  # noqa: E402
from repro_torch.core import agent  # noqa: E402
from repro_torch.core.controller import InTune  # noqa: E402
from repro_torch.data.pipeline import train_feed_pipeline  # noqa: E402
from repro_torch.data.simulator import MachineSpec  # noqa: E402


def _pair(head, seed=0):
    """A JAX agent and a port agent holding the JAX agent's weights."""
    kw = dict(obs_dim=16, n_stages=5, head=head, batch_size=8)
    j = jagent.DQNAgent(jagent.DQNConfig(**kw), seed=seed)
    t = agent.DQNAgent(agent.DQNConfig(**kw), seed=seed)
    t.load_state_dict(j.state_dict())
    return j, t


@pytest.mark.parametrize("head", ["joint", "factored"])
def test_q_values_and_greedy_actions_match(head):
    j, t = _pair(head)
    obs = np.random.RandomState(0).randn(64, 16).astype(np.float32)
    want = np.asarray(jagent.qnet_apply(j.params, jnp.asarray(obs), j.cfg))
    got = agent.qnet_apply(t.params, obs, t.cfg).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for o in obs:
        np.testing.assert_array_equal(
            agent.greedy_action(t.params, o, t.cfg),
            jagent.greedy_action(j.params, o, j.cfg))


@pytest.mark.parametrize("head", ["joint", "factored"])
def test_one_td_update_matches(head):
    """SGD(momentum=0.9, dampening=0) is the JAX `m = 0.9m + g; p -= lr m`:
    after one update on the same replay batch the weights agree."""
    j, t = _pair(head)
    rng = np.random.RandomState(1)
    n = 8
    batch = (rng.randn(n, 16).astype(np.float32),
             rng.randint(0, 5, (n, 5)).astype(np.int64),
             rng.randn(n).astype(np.float32),
             rng.randn(n, 16).astype(np.float32),
             (rng.rand(n) < 0.2).astype(np.float32))
    j_params, _, j_loss = j.update(j.params, j.target, j.mom,
                                   *[jnp.asarray(b) for b in batch])
    t_loss = t.update(t.params, t.target, t.opt, *batch)
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=1e-5)
    got = agent.qnet_to_numpy(t.params)
    for layer in ("l1", "l2", "l3"):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[layer][k],
                                       np.asarray(j_params[layer][k]),
                                       rtol=1e-5, atol=1e-6)


def test_state_dict_keeps_the_jax_layout():
    j, t = _pair("factored")
    st = t.state_dict()
    for layer, p in j.state_dict()["qnet"].items():
        for k, v in p.items():
            assert st["qnet"][layer][k].shape == v.shape
            assert np.array_equal(st["qnet"][layer][k], v)
    flat = {f"{layer}/{k}": v for layer, p in st["qnet"].items()
            for k, v in p.items()}
    t2 = agent.DQNAgent(t.cfg, seed=5)
    t2.load_state_dict({"qnet": flat, "steps": 7})
    assert t2.steps == 7
    for a, b in zip(t2.params.parameters(), t.params.parameters()):
        assert torch.equal(a, b)


def test_intune_allocation_trace_matches_reference(tmp_path):
    """From one pretrained npz, on the same seeded PipelineSim, the port's
    controller makes the reference's allocations for 40 ticks."""
    cfg = jagent.DQNConfig(obs_dim=16, n_stages=5, head="factored")
    src = jagent.DQNAgent(cfg, seed=3).state_dict()
    path = tmp_path / "dqn_factored_r5.npz"
    np.savez(path, steps=0, **{f"qnet/{layer}/{k}": v
                               for layer, p in src["qnet"].items()
                               for k, v in p.items()})
    z = np.load(path)
    qnet = {}
    for key in z.files:
        if key.startswith("qnet/"):
            _, layer, k = key.split("/")
            qnet.setdefault(layer, {})[k] = z[key]
    state = {"qnet": qnet, "steps": int(z["steps"])}

    kw = dict(seed=0, head="factored", pretrained=state, finetune_ticks=30)
    ref = JInTune(j_train_feed(step_time_s=0.05), JMachine(n_cpus=32), **kw)
    port = InTune(train_feed_pipeline(step_time_s=0.05), MachineSpec(n_cpus=32),
                  **kw)
    for tick in range(40):
        a, b = ref.tick(), port.tick()
        assert list(a["workers"]) == list(b["workers"]), tick
        assert a["prefetch_mb"] == b["prefetch_mb"], tick
        np.testing.assert_allclose(b["reward"], a["reward"], rtol=1e-12)
