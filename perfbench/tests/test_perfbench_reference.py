"""The plain reference against the port at tiny sizes on the CPU: the
forward, the first three training steps (gradients and row-wise
adagrad), the optimizer's row-wise rule on its own, and the fed mix's
featurization."""
import numpy as np
import pytest
import torch

from perfbench.lib import correct, traffic, weights
from perfbench.reference import common
from perfbench.reference import featurize as ref_feat
from perfbench.tests import tiny

CELLS = ["dlrm-criteo.train-resident", "wide-deep.train-resident"]


def _full_rows(cfg):
    return [torch.arange(cfg["rows"]) for _ in range(cfg["n_sparse"])]


@pytest.mark.parametrize("name", CELLS)
def test_forward_matches_the_port(name):
    c = tiny.cell(name, param_dtype="float32")
    mod = c.model
    model, score = mod.build_serve(c.cfg, "cpu")
    weights.fill(model, mod.leaves(c.cfg), mod.TABLES, 123456789012)
    batch = traffic.make(c.cfg, c.mix, 5, "cpu")[0]
    got = score(batch)
    rows = _full_rows(c.cfg)
    init = weights.reference_init(mod.leaves(c.cfg), mod.TABLES,
                                  123456789012, torch.float32, "cpu",
                                  {n: rows for n in mod.TABLES})
    want = mod.reference_forward(init, correct.compact(batch, rows))
    torch.testing.assert_close(got.float(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("rows", [4096, 1 << 19])
def test_three_steps_match_the_port(name, rows):
    """rows 2^19 puts the tables over the row-wise threshold (2^24
    elements): their accumulator is one a row."""
    c = tiny.cell(name, param_dtype="float32", rows=rows)
    mod, cfg = c.model, c.cfg
    model, opt_state, step_fn = mod.build_train(cfg, 256, "cpu")
    leaves = mod.leaves(cfg)
    seed = 2 ** 33 + 17
    weights.fill(model, leaves, mod.TABLES, seed)
    first = traffic.make(cfg, c.mix, seed, "cpu")[:3]
    state = {"model": model, "opt": opt_state}

    def one(k, b):
        state["model"], state["opt"], m = step_fn(
            state["model"], state["opt"], cfg["optimizer"]["first_step"] + k,
            b)
        return m
    obs = correct.checked_steps(one, state, first, cfg, mod)
    ref = correct.reference_train(mod, cfg, seed, first, device="cpu")
    got = correct.train_numbers(obs, ref)
    assert got["loss_gap"] < 1e-5, got
    for k in ("grad_gap", "delta_gap", "row_grad_gap", "row_delta_gap",
              "repeat_row_grad_gap", "repeat_row_delta_gap",
              "dense_grad_gap", "dense_delta_gap"):
        assert got[k] < 1e-4, (k, got)
    assert set(obs["elem_grads"]) == {n for n, _, _ in leaves
                                      if n not in mod.TABLES}


@pytest.mark.parametrize("shape,store", [((3, 50, 4), torch.float32),
                                         ((3, 50, 4), torch.bfloat16),
                                         ((3, 50), torch.float32),
                                         ((7, 5), torch.float32)])
def test_rowwise_adagrad_matches_the_port(shape, store):
    """The reference's update on the touched rows of each part against
    the port's rowwise_adagrad on the whole leaf, the row-wise rule
    taken at 10 elements so that every 2-d and 3-d leaf here is
    row-wise; a (F, V) leaf keeps one accumulator a feature."""
    from repro_torch.train.optim import rowwise_adagrad
    g0 = torch.Generator().manual_seed(3)
    p = torch.randn(shape, generator=g0).to(store)
    grads = []
    for _ in range(2):
        g = torch.zeros(shape)
        rows = torch.randint(0, shape[1], (shape[0], 6), generator=g0)
        for f in range(shape[0]):
            g[f, rows[f]] = torch.randn((6,) + tuple(shape[2:]),
                                        generator=g0)
        grads.append(g.to(store))
    opt = rowwise_adagrad(lambda s: 0.01 * (s + 1), rowwise_min_elems=10)
    prog = {"x": p.clone()}
    state = opt.init(prog)
    for s, g in enumerate(grads):
        opt.update({"x": g.clone()}, state, prog, s)
    touched = [torch.unique(torch.nonzero(sum(g[f].float().abs() for g in
                                              grads).reshape(shape[1], -1)
                                          .sum(1))[:, 0])
               for f in range(shape[0])]
    parts = [p[f][touched[f]].float() for f in range(shape[0])]
    accs = [torch.zeros(q.shape[:-1]) for q in parts]
    for s, g in enumerate(grads):
        for f in range(shape[0]):
            common.adagrad_update(parts[f], g[f][touched[f]], accs[f],
                                  0.01 * (s + 1), 1e-10, shape[-1], store)
    for f in range(shape[0]):
        torch.testing.assert_close(prog["x"][f][touched[f]].float(),
                                   parts[f], rtol=0, atol=0)


@pytest.mark.parametrize("k_raw,hot", [(1, 1), (3, 4), (6, 4)])
def test_featurization_matches_the_port(k_raw, hot):
    from repro_torch.data.featurize import (RecordSpec, featurize_block,
                                            shuffle_block)
    cfg = {"n_sparse": 26, "n_dense": 13, "rows": 1 << 22, "multi_hot": hot}
    mix = {"n_batches": 2, "batch": 4096, "zipf_s": 1.05, "k_raw": k_raw}
    raw = [{k: v.numpy() for k, v in b.items()}
           for b in traffic.make(cfg, mix, 2 ** 31 + 5, "cpu", raw=True)]
    assert raw[0]["raw_ids"].shape == (4096, 26, k_raw)
    rs = RecordSpec(batch=4096, n_sparse=26, n_dense=13, vocab=1 << 22,
                    k_raw=k_raw, hot=hot)
    for blk in raw:
        got = featurize_block(shuffle_block(blk, np.random.RandomState(1)),
                              rs)
        want = ref_feat.featurize(blk, cfg["rows"], hot=hot)
        bad, gap, order = ref_feat.compare(got, want)
        assert bad == 0 and gap < 1e-5, (bad, gap)
        assert ref_feat.block_key(got["sparse_ids"].astype(np.int64)) \
            == ref_feat.block_key(want["sparse_ids"])
        np.testing.assert_array_equal(want["sparse_ids"][order],
                                      got["sparse_ids"])
        broken = dict(got, sparse_ids=got["sparse_ids"] + 1)
        assert ref_feat.compare(broken, want)[0] > 0
