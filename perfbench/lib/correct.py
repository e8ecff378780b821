"""What decides `correct`: the program's first three training steps, or
its scores, against the plain reference, number by number, each against
its limit (`perfbench/limits/<cell>.json`).

Training (`checked_steps` takes the steps; the harness's train mode and
`perfbench/control.py` both call it): the loss of each of the three
steps (the widest relative gap) and of the first (which no earlier
update's rounding reaches), the first step's gradient norm of each
leaf as the optimizer got it (worked out from its accumulator after one
step), and the norm of each leaf's change over the three steps. A norm's
gap is |program - reference| over the larger of the reference's norm of
that leaf and of the median leaf, the widest over the leaves. A leaf
whose reference gradient is under a thousandth of the median leaf's
moves by round-off alone and is left out of the change.

Rows and elements: a table row's first gradient norm and its change, the
median gap over the rows the batches read (`row_*`) and over the rows
read two or more times (`repeat_row_*`: the first batch's repeats for
the gradient, the three batches' for the change), each over the larger
of the reference's norm of that row and of the median row; a dense
(non-table) leaf's first gradient and change element by element, the
median gap over the leaf's elements, the widest over the leaves
(`dense_*`).

Scoring: the widest gap between a served logit and the reference's, over
every row of every batch. The fed mix also compares the featurization:
rows whose ids or label differ from what the reference makes of the raw
records, and the widest gap of a dense feature.
"""
from __future__ import annotations

import math
import statistics
from typing import Optional

import torch

from perfbench.lib import weights
from perfbench.reference import train as ref_train


def touched_rows(batches, n_sparse: int) -> list:
    """The sorted distinct rows each feature's ids read over `batches`."""
    return [torch.unique(torch.cat([b["sparse_ids"][:, f].reshape(-1)
                                    for b in batches]).long())
            for f in range(n_sparse)]


def row_hits(batches, rows: list) -> list:
    """How often `batches` read each of `rows` (a feature's), aligned
    with them."""
    out = []
    for f, r in enumerate(rows):
        ids = torch.cat([b["sparse_ids"][:, f].reshape(-1).long()
                         for b in batches])
        u, c = torch.unique(ids, return_counts=True)
        hits = torch.zeros(r.numel(), dtype=torch.long, device=r.device)
        hits[torch.searchsorted(r, u)] = c
        out.append(hits)
    return out


def compact(batch: dict, rows: list) -> dict:
    """A batch with its ids as indices into `rows` (the reference's)."""
    ids = batch["sparse_ids"].long()
    idx = torch.stack([torch.searchsorted(rows[f], ids[:, f].contiguous())
                       for f in range(len(rows))], dim=1)
    return {"ids": idx, "dense": batch["dense"].float(),
            "label": batch["label"].float()}


@torch.no_grad()
def _leaf_sq(p: torch.Tensor, q: torch.Tensor) -> float:
    return float((p.float() - q.float()).double().square().sum())


class TrainObservation:
    """The program's first steps as its own state shows them: snapshot
    before the first step (`before`), the accumulators after it
    (`after_first`), the losses, and the change after the third
    (`after_last`)."""

    def __init__(self, model, leaves, tables, rows):
        self.params = dict(model.named_parameters())
        self.leaves, self.tables, self.rows = leaves, tables, rows
        self.losses, self.grad_norms, self.deltas = [], {}, {}
        self.row_grads, self.row_deltas = {}, {}
        self.elem_grads, self.elem_deltas = {}, {}
        self._p0 = None

    @torch.no_grad()
    def _take(self, name):
        p = self.params[name]
        if name in self.tables:
            return [p[f][r].clone() for f, r in enumerate(self.rows)]
        return [p.detach().clone()]

    def before(self):
        self._p0 = {n: self._take(n) for n, _, _ in self.leaves}

    @torch.no_grad()
    def after_first(self, opt_state, optimizer: str):
        if optimizer not in ("rowwise_adagrad", "adagrad"):
            raise ValueError(f"no gradient norm from {optimizer!r}'s state")
        for n, shape, _ in self.leaves:
            acc = opt_state["acc"][n]
            ratio = self.params[n].numel() // acc.numel()
            self.grad_norms[n] = (float(acc.double().sum()) * ratio) ** 0.5
            if n in self.tables and len(shape) == 3:
                # a row's gradient norm: its accumulator is one a row
                # (x D) or one an element (summed over the row)
                self.row_grads[n] = [
                    (acc[f][r].float() * ratio if acc.dim() == 2
                     else acc[f][r].float().sum(-1)).sqrt()
                    for f, r in enumerate(self.rows)]
            elif n not in self.tables and acc.shape == shape:
                self.elem_grads[n] = acc.float().sqrt()

    def after_last(self):
        for n, shape, _ in self.leaves:
            now = self._take(n)
            self.deltas[n] = sum(_leaf_sq(a, b) for a, b in
                                 zip(now, self._p0[n])) ** 0.5
            if n in self.tables and len(shape) == 3:
                self.row_deltas[n] = [(a.float() - b.float()).norm(dim=-1)
                                      for a, b in zip(now, self._p0[n])]
            elif n not in self.tables:
                self.elem_deltas[n] = now[0].float() - self._p0[n][0].float()
        self._p0 = None

    def result(self) -> dict:
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "deltas": self.deltas, "row_grads": self.row_grads,
                "row_deltas": self.row_deltas,
                "elem_grads": self.elem_grads,
                "elem_deltas": self.elem_deltas}


def checked_steps(one, state: dict, batches: list, cfg: dict, mod) -> dict:
    """The checked steps: `one(k, batch)` runs the program's step k (from
    0) on `state` ({"model", "opt"}, which it updates) and returns its
    metrics; the program's state is observed around them."""
    rows = touched_rows(batches, cfg["n_sparse"])
    obs = TrainObservation(state["model"], mod.leaves(cfg), mod.TABLES,
                           rows)
    obs.before()
    for s, b in enumerate(batches):
        m = one(s, b)
        obs.losses.append(float(m["loss"]))
        if s == 0:
            obs.after_first(state["opt"], cfg["optimizer"]["name"])
    obs.after_last()
    out = obs.result()
    obs.params = None
    return out


def worst(values) -> float:
    """The largest of `values`; NaN where any is NaN."""
    values = [float(v) for v in values]
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def norm_gap(prog: dict, ref: dict, keep) -> float:
    """The widest |prog - ref| over the larger of ref's leaf and median
    leaf, over the leaves in `keep`."""
    keep = list(keep)
    med = statistics.median(ref[k] for k in keep)
    return worst(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                 for k in keep)


def worst_leaf(prog: dict, ref: dict) -> str:
    """The leaf whose norm's gap is widest (for a look at a reading)."""
    med = statistics.median(ref.values())
    return max(ref, key=lambda k: abs(prog[k] - ref[k])
               / max(ref[k], med, 1e-30))


def row_gap(prog: dict, ref: dict, hits: Optional[list] = None,
            least: int = 1) -> float:
    """The median, over the table rows the reference's norms reach (a
    row's first gradient, or its change over the steps) and, where
    `hits` is given, that were read `least` times or more, of the gap of
    the row's norm over the larger of the reference's norm of that row
    and of the median row: steady from seed to seed where the widest row
    swings with bf16's cancellations and roundings. NaN where no row
    qualifies."""
    gaps = []
    for n, parts in ref.items():
        r = torch.cat([q.float() for q in parts])
        p = torch.cat([q.float() for q in prog[n]])
        hit = r > 0
        if not bool(hit.any()):
            continue
        med = float(r[hit].median())
        if hits is not None:
            hit &= torch.cat(hits).to(r.device) >= least
        gaps.append(((p - r).abs() / torch.clamp(r, min=med))[hit])
    gaps = torch.cat(gaps) if gaps else torch.empty(0)
    return float(gaps.median()) if gaps.numel() else math.nan


def elem_gap(prog: dict, ref: dict) -> float:
    """The widest, over the leaves of `ref`, of the median over a leaf's
    elements of |program - reference| over the larger of the reference's
    magnitude of that element and its median over the leaf."""
    gaps = []
    for n, r in ref.items():
        r = r.float()
        p = prog[n].float().to(r.device)
        med = float(r.abs().median())
        gaps.append(float(((p - r).abs()
                           / torch.clamp(r.abs(), min=max(med, 1e-30)))
                          .median()))
    return worst(gaps) if gaps else math.nan


def train_numbers(obs: dict, ref: dict) -> dict:
    """The numbers of a training cell: obs is `checked_steps`'s, ref
    `reference_train`'s."""
    loss = worst(abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(obs["losses"], ref["losses"]))
    names = list(ref["grad_norms"])
    med_g = statistics.median(ref["grad_norms"].values())
    moved = [n for n in names if ref["grad_norms"][n] >= 1e-3 * med_g]
    first = obs["losses"][0], ref["losses"][0]
    return {"loss_gap": loss,
            "first_loss_gap": abs(first[0] - first[1]) / max(abs(first[1]),
                                                             1e-30),
            "grad_gap": norm_gap(obs["grad_norms"], ref["grad_norms"],
                                 names),
            "delta_gap": norm_gap(obs["deltas"], ref["deltas"], moved),
            "row_grad_gap": row_gap(obs["row_grads"], ref["row_grads"]),
            "row_delta_gap": row_gap(obs["row_deltas"], ref["row_deltas"]),
            "repeat_row_grad_gap": row_gap(obs["row_grads"],
                                           ref["row_grads"],
                                           ref["hits_first"], 2),
            "repeat_row_delta_gap": row_gap(obs["row_deltas"],
                                            ref["row_deltas"],
                                            ref["hits_all"], 2),
            "dense_grad_gap": elem_gap(obs["elem_grads"], ref["elem_grads"]),
            "dense_delta_gap": elem_gap(obs["elem_deltas"],
                                        ref["elem_deltas"])}


def reference_train(mod, cfg: dict, seed: int, batches: list,
                    precision: str = "f32", device="cuda") -> dict:
    """The reference's three steps from the seed's weights on `batches`
    (model-ready, in the program's order), at `precision`."""
    rows = touched_rows(batches, cfg["n_sparse"])
    store = getattr(torch, cfg["param_dtype"])
    leaves = mod.leaves(cfg)
    init = weights.reference_init(leaves, mod.TABLES, seed, store, device,
                                  {n: rows for n in mod.TABLES})
    cb = [compact(b, rows) for b in batches]
    with torch.enable_grad():
        out = ref_train.follow(
            mod.reference_forward, leaves, init, cb, cfg["optimizer"],
            precision, store, steps=len(batches),
            tables=[n for n, shape, _ in leaves
                    if n in mod.TABLES and len(shape) == 3],
            dense=[n for n, _, _ in leaves if n not in mod.TABLES])
    out["hits_first"] = row_hits(batches[:1], rows)
    out["hits_all"] = row_hits(batches, rows)
    return out


@torch.no_grad()
def reference_scores(mod, cfg: dict, seed: int, batches: list,
                     precision: str = "f32", device="cuda",
                     block: int = 65536) -> list:
    """The reference's logits of every row of `batches`, in blocks."""
    rows = touched_rows(batches, cfg["n_sparse"])
    store = getattr(torch, cfg["param_dtype"])
    init = weights.reference_init(mod.leaves(cfg), mod.TABLES, seed, store,
                                  device, {n: rows for n in mod.TABLES})
    out = []
    for b in batches:
        c = compact(b, rows)
        out.append(torch.cat([
            mod.reference_forward(init, {k: v[i:i + block]
                                         for k, v in c.items()}, precision)
            for i in range(0, c["ids"].shape[0], block)]))
    return out


def score_gap(outs: list, refs: list) -> float:
    """The widest |served logit - reference logit| over every row; a
    batch never served reads infinite."""
    gaps = []
    for o, r in zip(outs, refs):
        if o is None or o.shape != r.shape:
            return math.inf
        gaps.append(float((o.float() - r.float()).abs().max()))
    return worst(gaps)
