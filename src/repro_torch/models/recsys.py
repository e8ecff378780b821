"""The recsys family in PyTorch (port of repro/models/recsys.py on one
device): the MLP helpers and the CTR loss shared with the DLRM
(:33-58), wide-deep (:62-103), xDeepFM (:106-163), DIEN (:166-246),
BERT4Rec (:250-420), the losses and the retrieval `score_candidates`
(:394-488). Each model is an `nn.Module` whose `forward` is the
reference's forward function; `init_model` draws one from a seed.

On a mesh (a `ShardCtx` carrying a `launch.programs.Placement`) every
parameter is this rank's block of the reference's spec, and the model
runs the reference's sharded program with explicit collectives: the
dense stacks through the placed `apply_mlp` (fsdp blocks gathered over
the data axes, output columns split over the model axis); the tables
whose rows split through the row-sharded lookups (`table_lookup`):
wide-deep's tables and wide arm over every axis and xDeepFM's tables
and linear arm and DIEN's items over the model axis alone through
`tp_multifeature_bag`, BERT4Rec's sequence through `tp_embedding_lookup`
and its candidates through `tp_sampled_scores` (`tp_lookup`), whose sum
over the model axis moves the (B, M, C) logits, not gathered rows;
xDeepFM's CIN on this model rank's rows of the batch (the reference's
`act_all_batch`); DIEN's GRU weights fetched whole once a pass;
BERT4Rec's heads and FFN columns over the model axis, their partial
outputs summed over it. A weight every model rank uses alike is read
through the placement's fetch (`_weight`), which takes a 1 / tp share of
its gradient (launch/programs.py's convention).

Every table lookup runs through the hand-written kernels
(`repro_torch.kernels.ops`), forward and backward:
- wide-deep's deep tables and wide arm, and xDeepFM's linear arm, its
  (F, V) table viewed as (F, V, 1), through `ops.embedding_bag_fused`
  (the fused kernel where a feature's table is at most 8 MiB, the
  4 MiB arms at the published widths, the row kernel `embedding_bag_fwd`
  otherwise); a row-sharded arm on a mesh through the local-rows pair
  `embedding_bag_fwd_local` / `embedding_bag_bwd_local`, as the fused
  kernel has no local-rows mode;
- xDeepFM's tables through `ops.embedding_bag`;
- DIEN's and BERT4Rec's item gathers (the reference's `jnp.take`) as
  bags of one through `models.embedding.embedding_bag`, bitwise a take;
- the backward of all of them is the scatter kernel `embedding_bag_bwd`.
A `bag_fn` keyword replaces the kernel ops with their plain versions (a
comparison on the card uses it).

Parameters cross between the packages as numpy in the JAX layout (for
wide-deep `{"tables": (F, V, D), "wide": (F, V), "wide_dense": (n_dense,
1), "mlp": ({"w": (in, out), "b": (out,)}, ...), "bias": ()}`), through
`params_from_numpy` / `params_to_numpy`. Each module keeps the JAX
leaves under their JAX names, tuples as numbered children (`cin.0`,
`blocks.1.wqkv`), except the dense stacks (`mlp`, `dnn`): `nn.Linear`
holds each `w` transposed. `tree_from_named` / `named_from_tree` map the
module's names to the tree and back, for parameters and optimizer state
alike.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.shardlib import ShardCtx
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels import ops
from repro_torch.models.embedding import (
    embedding_bag, local_rows_take, tp_embedding_lookup, tp_multifeature_bag)
from repro_torch.models.exchange import generator, transpose
from repro_torch.train import collectives as coll


def init_mlp(dims: Sequence[int], *, generator: Optional[torch.Generator],
             device="cuda", dtype=torch.float32) -> nn.ModuleList:
    """Dense stack dims[0] -> ... -> dims[-1]: weights ~ N(0, 1/fan_in),
    biases zero, as the JAX package initializes them. `nn.Linear` keeps
    its weight as (out, in), the transpose of the JAX layout."""
    layers = nn.ModuleList()
    for i in range(len(dims) - 1):
        lin = nn.Linear(dims[i], dims[i + 1], device="meta", dtype=dtype)
        lin = lin.to_empty(device=device)
        with torch.no_grad():
            lin.weight.normal_(generator=generator).mul_(dims[i] ** -0.5)
            lin.bias.zero_()
        layers.append(lin)
    return layers


def mlp_logical(prefix: str, layers: nn.ModuleList) -> dict:
    """The reference's logical axes of a dense stack's leaves (its
    `init_mlp`'s: `w` ("fsdp", "mlp"), `b` ("mlp",)) under the port's
    names `<prefix>.<i>.weight` / `.bias`; an `nn.Linear` weight (out,
    in) is `w` transposed."""
    out = {}
    for i in range(len(layers)):
        out[f"{prefix}.{i}.weight"] = ("mlp", "fsdp")
        out[f"{prefix}.{i}.bias"] = ("mlp",)
    return out


def apply_mlp(layers: nn.ModuleList, x: torch.Tensor,
              act: Callable = torch.relu, final_act: bool = False, *,
              placement=None, prefix: Optional[str] = None) -> torch.Tensor:
    """The dense stack on x. Under a `placement` (launch/programs.
    Placement; `prefix` the stack's parameter name) each layer's weight
    (out, in), the reference's (in, out) `w` on ("fsdp", "mlp"), is
    gathered whole over the data axes, and a layer whose output dim is
    split over the model axis computes this model rank's columns, which
    are all-gathered over the model axis before the next layer: summed
    by its backward's reduce-scatter where the next layer is split too
    (its input's gradient is then each rank's part), kept as this rank's
    slice where the next one runs alike on every model rank (an output
    width that does not divide, the last layer's 1); the input of the
    first split layer after an alike one sums its gradient over the
    model ranks (`same_to_parts`). x is alike on every model rank."""
    if placement is None:
        for i, lin in enumerate(layers):
            x = lin(x)
            if final_act or i < len(layers) - 1:
                x = act(x)
        return x
    pl, n = placement, len(layers)
    names = [f"{prefix}.{i}" for i in range(n)]
    split = [pl.on_model(pl.specs[f"{k}.weight"], 0) for k in names]
    for i, k in enumerate(names):
        use = "keep" if split[i] else "same"
        w = pl.fetch(layers[i].weight, pl.specs[f"{k}.weight"], use)
        b = pl.fetch(layers[i].bias, pl.specs[f"{k}.bias"], use)
        if split[i] and (i == 0 or not split[i - 1]):
            x = coll.same_to_parts(x, pl.tpg)
        x = F.linear(x, w, b)
        if final_act or i < n - 1:
            x = act(x)
        if split[i]:
            gather = coll.all_gather_sum if i + 1 < n and split[i + 1] \
                else coll.all_gather_same
            # contiguous both ways: the GEMMs on either side read their
            # operands, and the gradients, as they do on one device
            x = coll.contiguous(gather(coll.contiguous(x), pl.tpg, -1))
    return x


def bce_loss(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in the stable form."""
    logit = logit.float()
    loss = torch.clamp(logit, min=0) - logit * label \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    return loss.mean()


def _normal(shape, scale, *, dtype, device, generator) -> nn.Parameter:
    """A parameter ~ scale * N(0, 1), drawn on `device` from `generator`."""
    t = torch.empty(shape, dtype=dtype, device=device)
    with torch.no_grad():
        t.normal_(generator=generator).mul_(scale)
    return nn.Parameter(t)


def _const(shape, value, *, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


def _take(table: torch.Tensor, ids: torch.Tensor,
          bag_fn: Optional[Callable]) -> torch.Tensor:
    """The reference's `jnp.take(table, ids, axis=0)`: table (V, D), ids
    (...) int32 -> (..., D) f32, as bags of one through the row kernel
    (or `bag_fn`)."""
    return embedding_bag(table, ids[..., None], bag_fn=bag_fn)


def _placement(ctx):
    """The placement a ShardCtx carries (None: the model is whole)."""
    return None if ctx is None else getattr(ctx, "placement", None)


def table_lookup(model: nn.Module, name: str, ids: torch.Tensor, pl,
                  bag_fn: Callable, *,
                  view: Callable = lambda t: t) -> torch.Tensor:
    """The bag lookup of `model`'s table `name`, `view(table)` its (F, V,
    D) form: under a placement `pl` whose spec splits its rows, this
    rank's shard through `tp_multifeature_bag` over the axes they span;
    else the whole table through `bag_fn` (under `pl` read alike on every
    model rank)."""
    table = getattr(model, name)
    if pl is None:
        return bag_fn(view(table), ids)
    axes = pl.rows_axes(name)
    if axes is None:
        return bag_fn(view(pl.fetch(table, pl.specs[name], "same")), ids)
    rows = pl.shapes[name][pl.logical[name].index("table_rows")]
    return tp_multifeature_bag(view(table), ids, pl.mesh, rows=rows,
                               axes=axes)


def _item_take(model: nn.Module, ids: torch.Tensor, pl,
               bag_fn: Optional[Callable]) -> torch.Tensor:
    """The take of `model.items` (V, D) rows at ids (...) int32 -> (...,
    D), as bags of one of a (1, V, D) table (`table_lookup`)."""
    out = table_lookup(model, "items", ids.reshape(-1, 1, 1), pl,
                       bag_fn or ops.embedding_bag, view=lambda t: t[None])
    return out.reshape(*ids.shape, model.items.shape[-1])


def _weight(model: nn.Module, name: str, pl) -> torch.Tensor:
    """Parameter `name` of `model` used alike on every model rank:
    fetched whole under a placement `pl`, itself without one."""
    if pl is None:
        return getattr(model, name)
    return pl.param(model, name, "same")


# =============================================================== wide-deep ==
class WideDeep(nn.Module):
    """Stacked (F, V, D) deep tables, the (F, V) wide table, the wide arm's
    dense weights (n_dense, 1), the deep MLP and a scalar bias."""

    def __init__(self, cfg: RecsysConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        rows = cfg.vocab_sizes[0]

        def normal(shape, scale):
            return _normal(shape, scale, dtype=dtype, device=device,
                           generator=generator)
        self.tables = normal((cfg.n_sparse, rows, cfg.embed_dim),
                             cfg.embed_dim ** -0.5)
        self.wide = normal((cfg.n_sparse, rows), 0.01)
        deep_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
        self.mlp = init_mlp((deep_in,) + cfg.mlp_dims + (1,),
                            generator=generator, device=device, dtype=dtype)
        self.wide_dense = normal((cfg.n_dense, 1), 0.01)
        self.bias = nn.Parameter(torch.zeros((), dtype=dtype, device=device))

    def param_logical(self) -> dict:
        """{parameter name: the reference's logical axes} (its
        `init_wide_deep`'s `logical` tree)."""
        return {"tables": (None, "table_rows", "table_dim"),
                "wide": (None, "table_rows"), "wide_dense": (None, None),
                "bias": (), **mlp_logical("mlp", self.mlp)}

    def forward(self, batch: Dict[str, torch.Tensor], *,
                bag_fn: Optional[Callable] = None,
                emb: Optional[torch.Tensor] = None, ctx=None) -> torch.Tensor:
        """batch: sparse_ids (B, F, hot) int32, dense (B, n_dense) ->
        logits (B,). `bag_fn(tables, ids)` replaces the kernel op (a
        comparison against the plain version on the card uses it); `emb`
        (B, F, D), where given, replaces the deep tables' lookup (the
        retrieval's); `ctx` a ShardCtx (its placement: the row-sharded
        lookups, the placed deep MLP)."""
        bag_fn = bag_fn or ops.embedding_bag_fused
        pl = _placement(ctx)
        ids = batch["sparse_ids"]
        if emb is None:
            emb = table_lookup(self, "tables", ids, pl, bag_fn)  # (B, F, D)
        dense = batch["dense"].to(emb.dtype)
        deep_in = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=-1)
        deep_logit = apply_mlp(self.mlp, deep_in, placement=pl,
                               prefix="mlp")[:, 0]
        # wide arm: per-feature scalar weights, multi-hot summed (the bag
        # in the lookup, then the features)
        wide_w = table_lookup(self, "wide", ids, pl, bag_fn,
                               view=lambda t: t.unsqueeze(-1))  # (B, F, 1)
        wide_logit = wide_w.sum(dim=(1, 2)) \
            + (dense @ _weight(self, "wide_dense", pl))[:, 0]
        return deep_logit + wide_logit + _weight(self, "bias", pl)


# ================================================================= xdeepfm ==
class XDeepFM(nn.Module):
    """Stacked (F, V, D) tables, the (F, V) linear table, the CIN filters
    `cin` (each (H_k, H_{k-1}, F)), the DNN, the CIN's output weights
    `cin_out` (sum H_k, 1) and a scalar bias."""

    def __init__(self, cfg: RecsysConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        rows, m = cfg.vocab_sizes[0], cfg.n_sparse
        self.tables = _normal((m, rows, cfg.embed_dim),
                              cfg.embed_dim ** -0.5, generator=generator,
                              **kw)
        self.linear = _normal((m, rows), 0.01, generator=generator, **kw)
        # CIN filters: layer k maps (H_{k-1} x m) interactions -> H_k maps
        cin, h_prev = [], m
        for h in cfg.cin_dims:
            cin.append(_normal((h, h_prev, m), (h_prev * m) ** -0.5,
                               generator=generator, **kw))
            h_prev = h
        self.cin = nn.ParameterList(cin)
        dnn_in = m * cfg.embed_dim + cfg.n_dense
        self.dnn = init_mlp((dnn_in,) + cfg.mlp_dims + (1,),
                            generator=generator, **kw)
        n_cin = sum(cfg.cin_dims)
        self.cin_out = _normal((n_cin, 1), n_cin ** -0.5,
                               generator=generator, **kw)
        self.bias = _const((), 0.0, **kw)

    def param_logical(self) -> dict:
        """{parameter name: the reference's logical axes} (its
        `init_xdeepfm`'s `logical` tree)."""
        return {"tables": (None, "table_rows", "table_dim"),
                "linear": (None, "table_rows"),
                **{f"cin.{i}": ("mlp", None, None)
                   for i in range(len(self.cin))},
                **mlp_logical("dnn", self.dnn), "cin_out": (None, None),
                "bias": ()}

    def forward(self, batch: Dict[str, torch.Tensor], *,
                bag_fn: Optional[Callable] = None,
                emb: Optional[torch.Tensor] = None, ctx=None) -> torch.Tensor:
        """batch: sparse_ids (B, F, hot) int32, dense (B, n_dense) ->
        logits (B,). `bag_fn` replaces both kernel ops; `emb` (B, F, D),
        where given, replaces the tables' lookup (the retrieval's); `ctx`
        a ShardCtx (its placement: the tables and the linear arm through
        the row-sharded lookup over their rows' axes, the placed DNN, and
        the CIN on this model rank's rows, the reference's
        `act_all_batch`, where they divide over the model ranks)."""
        pl = _placement(ctx)
        ids = batch["sparse_ids"]
        x0 = emb if emb is not None else table_lookup(
            self, "tables", ids, pl, bag_fn or ops.embedding_bag)  # (B,m,D)
        # the CIN's batch over every axis: this model rank's rows of its
        # data rank's, the filters whole (their gradients each rank's
        # part, summed over the model ranks), the pooled maps gathered
        split = pl is not None and pl.tpg is not None \
            and x0.shape[0] % pl.tp == 0
        x0c = coll.split_same(x0, pl.tpg, 0) if split else x0
        # x_k[b,h,d] = sum_{i,j} W[h,i,j] * x_{k-1}[b,i,d] * x0[b,j,d],
        # associated as the reference's (contract i, then j), with d kept
        # next to b: u (B, D, H, m) comes out of one GEMM and feeds a
        # batched product over (b, d) as it lies, where the reference's
        # (B, H, m, D) layout would be copied into that order (and its
        # gradient out of it) in each direction, 20 GB a layer at
        # train_batch
        x0t = x0c.transpose(1, 2).contiguous()                    # (B, D, m)
        xk, pooled = x0t, []
        for i, w in enumerate(self.cin):
            if pl is not None:
                w = pl.fetch(w, pl.specs[f"cin.{i}"],
                             "parts" if split else "same")
            u = torch.einsum("bdi,hij->bdhj", xk, w)
            xk = torch.einsum("bdhj,bdj->bdh", u, x0t)            # (B, D, H_k)
            pooled.append(xk.sum(dim=1))                          # (B, H_k)
        pooled = torch.cat(pooled, dim=-1)
        if split:
            pooled = coll.all_gather_same(pooled, pl.tpg, 0)
        cin_logit = (pooled @ _weight(self, "cin_out", pl))[:, 0]
        dnn_in = torch.cat([x0.reshape(x0.shape[0], -1),
                            batch["dense"].to(x0.dtype)], dim=-1)
        dnn_logit = apply_mlp(self.dnn, dnn_in, placement=pl,
                              prefix="dnn")[:, 0]
        lin_w = table_lookup(self, "linear", ids, pl,
                              bag_fn or ops.embedding_bag_fused,
                              view=lambda t: t.unsqueeze(-1))     # (B, m, 1)
        return cin_logit + dnn_logit + lin_w.sum(dim=(1, 2)) \
            + _weight(self, "bias", pl)


# ==================================================================== dien ==
class GRUCell(nn.Module):
    """`w` (d_in, 3h), `u` (h, 3h), `b` (3h,), gates along 3h in the order
    reset, update, candidate (the reference's `_gru_init`; `LOGICAL` its
    leaves' logical axes)."""

    LOGICAL = {"w": ("fsdp", "mlp"), "u": ("fsdp", "mlp"), "b": ("mlp",)}

    def __init__(self, d_in: int, d_h: int, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w = _normal((d_in, 3 * d_h), d_in ** -0.5, generator=generator,
                         **kw)
        self.u = _normal((d_h, 3 * d_h), d_h ** -0.5, generator=generator,
                         **kw)
        self.b = _const((3 * d_h,), 0.0, **kw)

    def weights(self, pl=None, prefix: str = "") -> tuple:
        """(w, u, b): under a placement `pl` (`prefix` the cell's name)
        fetched whole, over the data axes and, where the gates' dim is
        split, over the model axis, once a pass: a model rank's columns
        are not whole gates (3 x 108 = 324 splits over 2 ranks, not
        whole ones), and every model rank then runs the cell alike, with
        no collective a step."""
        if pl is None:
            return self.w, self.u, self.b
        return tuple(pl.fetch(getattr(self, k), pl.specs[f"{prefix}.{k}"],
                              "same") for k in ("w", "u", "b"))

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                a: Optional[torch.Tensor] = None,
                weights: Optional[tuple] = None) -> torch.Tensor:
        """The reference's `_gru_cell`, written out (not `nn.GRU`, whose
        candidate bias sits inside the reset product): the bias on x @ w
        only, n = tanh(xw_n + r * hu_n); with `a` (B,), AUGRU: the update
        gate scaled by a. `weights` (w, u, b), where given, are the
        cell's fetched ones (`weights`)."""
        w, u, b = weights or (self.w, self.u, self.b)
        d_h = h.shape[-1]
        xw = x @ w + b
        hu = h @ u
        r = torch.sigmoid(xw[..., :d_h] + hu[..., :d_h])
        z = torch.sigmoid(xw[..., d_h:2 * d_h] + hu[..., d_h:2 * d_h])
        n = torch.tanh(xw[..., 2 * d_h:] + r * hu[..., 2 * d_h:])
        if a is not None:
            z = z * a[:, None]
        return (1 - z) * h + z * n


class DIEN(nn.Module):
    """The (V, D) item table, the interest extractor `gru1`, the AUGRU
    `gru2`, the attention weights `att_w` (H, D) and the MLP."""

    def __init__(self, cfg: RecsysConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        d, h = cfg.embed_dim, cfg.gru_dim
        self.items = _normal((cfg.vocab_sizes[0], d), d ** -0.5,
                             generator=generator, **kw)
        self.gru1 = GRUCell(d, h, generator=generator, **kw)
        self.gru2 = GRUCell(h, h, generator=generator, **kw)
        self.att_w = _normal((h, d), h ** -0.5, generator=generator, **kw)
        self.mlp = init_mlp((h + d + cfg.n_dense,) + cfg.mlp_dims + (1,),
                            generator=generator, **kw)

    def param_logical(self) -> dict:
        """{parameter name: the reference's logical axes} (its
        `init_dien`'s `logical` tree)."""
        return {"items": ("table_rows", "table_dim"),
                **{f"{c}.{k}": lg for c in ("gru1", "gru2")
                   for k, lg in GRUCell.LOGICAL.items()},
                "att_w": (None, None), **mlp_logical("mlp", self.mlp)}

    def interest_states(self, hist_emb: torch.Tensor,
                        pl=None) -> torch.Tensor:
        """The first GRU pass (target-independent), a step of the
        sequence at a time: (B, S, D) -> (B, S, H)."""
        weights = self.gru1.weights(pl, "gru1")
        h = hist_emb.new_zeros((hist_emb.shape[0], self.cfg.gru_dim))
        states = []
        # unbind, not hist_emb[:, t]: the backward of S selects would
        # write S zero-filled (B, S, D) gradients and add them up
        for x_t in hist_emb.unbind(1):
            h = self.gru1(x_t, h, weights=weights)
            states.append(h)
        return torch.stack(states, dim=1)

    def evolve(self, states: torch.Tensor, target_emb: torch.Tensor,
               hist_mask: torch.Tensor, pl=None) -> torch.Tensor:
        """Attention over the states against the target, then the AUGRU
        pass; the final interest (B, H). The scores are the reference's
        einsum("bsh,hd,bd->bs"), contracted as (target @ att_w^T) first;
        the softmax is taken in f32 with masked positions at -1e30."""
        weights = self.gru2.weights(pl, "gru2")
        scores = torch.einsum("bsh,bh->bs", states,
                              target_emb @ _weight(self, "att_w", pl).t())
        scores = torch.where(hist_mask > 0, scores, -1e30)
        att = torch.softmax(scores.float(), dim=-1).to(states.dtype)
        h = states.new_zeros((states.shape[0], self.cfg.gru_dim))
        for s_t, a_t in zip(states.unbind(1), att.unbind(1)):
            h = self.gru2(s_t, h, a=a_t, weights=weights)
        return h

    def history(self, batch, bag_fn=None, pl=None) -> torch.Tensor:
        """The history's item rows (B, S, D), zero past its mask."""
        hist = _item_take(self, batch["hist_ids"], pl, bag_fn)
        return hist * batch["hist_mask"][..., None].to(hist.dtype)

    def head(self, interest, target, dense, pl=None) -> torch.Tensor:
        feats = torch.cat([interest, target, dense.to(interest.dtype)], -1)
        return apply_mlp(self.mlp, feats, placement=pl, prefix="mlp")[:, 0]

    def forward(self, batch: Dict[str, torch.Tensor], *,
                bag_fn: Optional[Callable] = None, ctx=None) -> torch.Tensor:
        """batch: hist_ids (B, S) int32, hist_mask (B, S), target_id (B,)
        int32, dense (B, n_dense) -> logits (B,). `ctx` a ShardCtx (its
        placement: the items through the row-sharded lookup over their
        rows' axes, the GRU cells' weights fetched whole, the placed
        MLP)."""
        pl = _placement(ctx)
        hist = self.history(batch, bag_fn, pl)
        target = _item_take(self, batch["target_id"], pl, bag_fn)
        states = self.interest_states(hist, pl)
        interest = self.evolve(states, target, batch["hist_mask"], pl)
        return self.head(interest, target, batch["dense"], pl)


# ================================================================ bert4rec ==
class Block(nn.Module):
    """One encoder block in the reference's layout: `wqkv` (d, 3, h, d/h),
    `wo` (h, d/h, d), `ln1`, `ln2` (d,), `ffn_in` (d, 4d), `ffn_b` (4d,),
    `ffn_out` (4d, d); `LOGICAL` their logical axes."""

    LOGICAL = {"wqkv": ("fsdp", None, "heads", "head_dim"),
               "wo": ("heads", "head_dim", "fsdp"), "ln1": ("embed",),
               "ln2": ("embed",), "ffn_in": ("fsdp", "mlp"),
               "ffn_b": ("mlp",), "ffn_out": ("mlp", "fsdp")}

    def __init__(self, d: int, n_heads: int, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        g = dict(generator=generator, **kw)
        self.wqkv = _normal((d, 3, n_heads, d // n_heads), d ** -0.5, **g)
        self.wo = _normal((n_heads, d // n_heads, d), d ** -0.5, **g)
        self.ln1 = _const((d,), 1.0, **kw)
        self.ln2 = _const((d,), 1.0, **kw)
        self.ffn_in = _normal((d, 4 * d), d ** -0.5, **g)
        self.ffn_b = _const((4 * d,), 0.0, **kw)
        self.ffn_out = _normal((4 * d, d), (4 * d) ** -0.5, **g)

    def forward(self, x: torch.Tensor, pl=None,
                prefix: str = "") -> torch.Tensor:
        """x (B, S, d) -> (B, S, d). Under a placement `pl` (`prefix` the
        block's name) the weights' fsdp blocks are gathered over the data
        axes; where the heads (the FFN's 4d) split over the model ranks,
        each rank runs its own heads (columns) on the normed stream, whose
        gradient is summed over them (`same_to_parts`), and the partial
        outputs are summed over them (`psum_same`); the norms and an
        unsplit part run alike on every model rank."""
        if pl is None:
            w = {k: getattr(self, k) for k in _BLOCK_KEYS}
            heads = ffn = None
        else:
            spec = {k: pl.specs[f"{prefix}.{k}"] for k in _BLOCK_KEYS}
            heads = pl.tpg if pl.on_model(spec["wqkv"], 2) else None
            ffn = pl.tpg if pl.on_model(spec["ffn_in"], 1) else None
            split = {"wqkv": heads, "wo": heads, "ffn_in": ffn,
                     "ffn_b": ffn, "ffn_out": ffn}
            w = {k: pl.fetch(getattr(self, k), spec[k],
                             "keep" if split.get(k) else "same")
                 for k in _BLOCK_KEYS}
        h = _layer_norm(x, w["ln1"])
        if heads is not None:
            h = coll.same_to_parts(h, heads)
        qkv = torch.einsum("bsd,dthk->tbshk", h, w["wqkv"])
        q, k, v = qkv.unbind(0)
        # scores in f32, directly (S = 200 is small), as the reference
        sc = torch.einsum("bshk,bthk->bhst", q, k).float()
        sc = sc * (q.shape[-1] ** -0.5)
        p = torch.softmax(sc, dim=-1).to(v.dtype)
        o = torch.einsum("bhst,bthk->bshk", p, v)
        attn = torch.einsum("bshk,hkd->bsd", o, w["wo"])
        if heads is not None:
            attn = coll.psum_same(attn, heads)
        x = x + attn
        h2 = _layer_norm(x, w["ln2"])
        if ffn is not None:
            h2 = coll.same_to_parts(h2, ffn)
        # jax.nn.gelu's default is the tanh approximation
        f = F.gelu(h2 @ w["ffn_in"] + w["ffn_b"], approximate="tanh") \
            @ w["ffn_out"]
        if ffn is not None:
            f = coll.psum_same(f, ffn)
        return x + f


_BLOCK_KEYS = ("wqkv", "wo", "ln1", "ln2", "ffn_in", "ffn_b", "ffn_out")


def _layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """The reference's `_layer_norm`: no bias, the population variance,
    in f32."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps) * w).to(x.dtype)


class BERT4Rec(nn.Module):
    """The item table (n_items + MASK + PAD rows, padded to a multiple of
    16; MASK is id n_items), the positions `pos` (S, d), the encoder
    `blocks` and the final norm `ln_f`."""

    def __init__(self, cfg: RecsysConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        d = cfg.embed_dim
        self.vocab = vocab = -(-(cfg.n_items + 2) // 16) * 16
        self.items = _normal((vocab, d), d ** -0.5, generator=generator,
                             **kw)
        self.pos = _normal((cfg.seq_len, d), 0.02, generator=generator,
                           **kw)
        self.blocks = nn.ModuleList(
            Block(d, cfg.n_heads, generator=generator, **kw)
            for _ in range(cfg.n_blocks))
        self.ln_f = _const((d,), 1.0, **kw)

    def param_logical(self) -> dict:
        """{parameter name: the reference's logical axes} (its
        `init_bert4rec`'s `logical` tree)."""
        return {"items": ("table_rows", "table_dim"), "pos": ("seq", "embed"),
                **{f"blocks.{i}.{k}": lg for i in range(len(self.blocks))
                   for k, lg in Block.LOGICAL.items()},
                "ln_f": ("embed",)}

    def encode(self, item_seq: torch.Tensor, *,
               bag_fn: Optional[Callable] = None, ctx=None) -> torch.Tensor:
        """item_seq (B, S) int32 -> hidden (B, S, D), bidirectional. `ctx`
        a ShardCtx (its placement: the items through
        `tp_embedding_lookup` where their rows split, the placed
        blocks)."""
        pl = _placement(ctx)
        if pl is not None and pl.rows_axes("items") is not None:
            emb = tp_embedding_lookup(self.items, item_seq, pl.mesh,
                                      rows=self.vocab)
        else:
            emb = _take(_weight(self, "items", pl), item_seq, bag_fn)
        x = emb + _weight(self, "pos", pl)
        for i, blk in enumerate(self.blocks):
            x = blk(x, pl, f"blocks.{i}")
        return _layer_norm(x, _weight(self, "ln_f", pl))

    def forward(self, batch: Dict[str, torch.Tensor], *,
                bag_fn: Optional[Callable] = None) -> torch.Tensor:
        """Masked-item logits over the full item vocab (B, S, vocab): only
        for small vocabs (the tests); training takes
        `sampled_logits`."""
        hidden = self.encode(batch["item_seq"], bag_fn=bag_fn)
        return torch.einsum("bsd,vd->bsv", hidden, self.items)

    def sampled_logits(self, batch: Dict[str, torch.Tensor], *,
                       bag_fn: Optional[Callable] = None,
                       ctx=None) -> torch.Tensor:
        """Sampled-softmax cloze logits at the masked positions: batch
        item_seq (B, S), mask_pos (B, M), mask_labels (B, M), neg_ids (B,
        M, N) -> (B, M, 1 + N), index 0 the true item. Under a placement
        whose items' rows split, with `tp_lookup` the reference's
        `tp_sampled_scores` (the logits summed over the model axis); else
        the candidates' rows taken from the table fetched whole."""
        hidden = self.encode(batch["item_seq"], bag_fn=bag_fn, ctx=ctx)
        h = torch.take_along_dim(hidden, batch["mask_pos"].long()[..., None],
                                 dim=1)                           # (B, M, D)
        cand = torch.cat([batch["mask_labels"][..., None], batch["neg_ids"]],
                         dim=-1)                                  # (B, M, 1+N)
        pl = _placement(ctx)
        if pl is not None and self.cfg.tp_lookup \
                and pl.rows_axes("items") is not None:
            return tp_sampled_scores(self.items, h, cand, pl.mesh,
                                     rows=self.vocab)
        emb = _take(_weight(self, "items", pl), cand, bag_fn)
        return torch.einsum("bmd,bmnd->bmn", h, emb)               # (B,M,1+N)


def tp_sampled_scores(items: torch.Tensor, h: torch.Tensor,
                      cand: torch.Tensor, mesh, *,
                      rows: Optional[int] = None) -> torch.Tensor:
    """Candidate scores against a row-sharded item table: items (rows /
    tp, D), this rank's shard over the model axis; h (B, M, D) and cand
    (B, M, C) int32, this data rank's -> (B, M, C). Each model rank
    scores only the candidates it owns (the rest read 0 rows through
    `local_rows_take`, in the table's dtype) and the sum over the model
    axis moves the logits, not the gathered rows; the gradient of the
    items lands in
    the local shard, and h's, summed over the model axis, is whole on
    every model rank. Falls back to the whole table's scores where the
    reference does (no model axis, one shard, rows not divisible, no
    `rows`), but at one shard of a mesh made with `exchange_one_shard`
    (models/embedding.py)."""
    names = mesh.axis_names if mesh is not None else ()
    tp = mesh.shape["model"] if "model" in names else 1
    if rows is None or "model" not in names or rows % tp != 0 \
            or (tp == 1 and not mesh.exchange_one_shard):
        return torch.einsum("bmd,bmnd->bmn", h, _take(items, cand, None))
    v_loc = rows // tp
    if items.shape[0] != v_loc:
        raise ValueError(f"a row shard of {v_loc} rows was expected, the "
                         f"items passed have {items.shape[0]}")
    group = mesh.group("model")
    emb = local_rows_take(items, cand, mesh.index("model") * v_loc)
    part = torch.einsum("bmd,bmnd->bmn", coll.same_to_parts(h, group),
                        emb.to(h.dtype))
    return coll.psum_same(part, group)


# ----------------------------------------------------------- entrypoints ---
MODELS = {"wide-deep": WideDeep, "xdeepfm": XDeepFM, "dien": DIEN,
          "bert4rec": BERT4Rec}


def init_model(cfg: RecsysConfig, *, seed: int = 0,
               device="cuda") -> nn.Module:
    """The model of `cfg.name` with random weights drawn on `device` from
    `seed`, in the reference's shapes and scales."""
    gen = generator(device, seed)
    return MODELS[cfg.name](cfg, device=device, generator=gen)


def ctr_loss(model: nn.Module, batch: Dict[str, torch.Tensor], **kw):
    """The BCE of a CTR model's logits (wide-deep, xDeepFM, DIEN)."""
    logit = model(batch, **kw)
    loss = bce_loss(logit, batch["label"].float())
    return loss, {"bce": loss}


def _masked_mean(nll: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def bert4rec_loss(model: BERT4Rec, batch: Dict[str, torch.Tensor], **kw):
    """Sampled-softmax masked-item loss (the true item at index 0)."""
    logits = model.sampled_logits(batch, **kw)
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = (batch["mask_labels"] >= 0).float()
    loss = _masked_mean(-logp[..., 0], mask)
    return loss, {"xent": loss}


def bert4rec_full_softmax_loss(model: BERT4Rec,
                               batch: Dict[str, torch.Tensor], **kw):
    """Full-vocab cloze loss over labels (B, S) (-1 unmasked): the
    small-vocab variant."""
    logits = model(batch, **kw)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(
        logp, torch.clamp(labels, min=0).long()[..., None], dim=-1)[..., 0]
    loss = _masked_mean(nll, (labels >= 0).float())
    return loss, {"xent": loss}


def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor], **kw):
    """The training loss of the model's arch: the sampled softmax for
    BERT4Rec, the BCE of the CTR models."""
    if isinstance(model, BERT4Rec):
        return bert4rec_loss(model, batch, **kw)
    return ctr_loss(model, batch, **kw)


@torch.no_grad()
def score_candidates(model: nn.Module, user: Dict[str, torch.Tensor],
                     cand_ids: torch.Tensor, *, chunks: int = 1,
                     bag_fn: Optional[Callable] = None,
                     placement=None) -> torch.Tensor:
    """Retrieval: score ONE user against C candidates -> (C,) scores, in
    `chunks` sequential slabs of C (C must divide), which bound the live
    working set (a slab of 40,000 candidates of xDeepFM's CIN holds a
    12.5 GB interaction tensor). The user's side is computed once:
    BERT4Rec scores the last position's hidden state against each
    candidate's row; DIEN's interest states are broadcast to the
    candidates, each the target; a CTR model's candidate replaces sparse
    feature 0 (ids mod V), the user's other embeddings gathered once.
    `bag_fn` replaces the kernel ops, as in `forward`.

    Under a `placement` (the model's parameters its blocks) each data
    rank scores its contiguous slice of C in the same `chunks` and the
    scores are all-gathered over the data ranks in candidate order (the
    reference's retrieval program shards the candidates over the data
    axes); the tables are read by the row-sharded lookups training uses:
    BERT4Rec's sequence and candidates through `tp_embedding_lookup`,
    DIEN's items and a CTR model's user bags and candidate rows (bags of
    one of table 0) through `tp_multifeature_bag`, and the dense layers
    are the placed ones."""
    cfg = model.cfg
    pl = placement
    cand_ids, group = coll.data_slice(cand_ids, chunks,
                                      pl.mesh if pl is not None else None)
    ctx = ShardCtx(placement=pl) if pl is not None else None
    if isinstance(model, BERT4Rec):
        u = model.encode(user["item_seq"], bag_fn=bag_fn,
                         ctx=ctx)[0, -1]                          # (D,)
        if pl is not None and pl.rows_axes("items") is not None:
            score = lambda ids: tp_embedding_lookup(
                model.items, ids, pl.mesh, rows=model.vocab) @ u
        else:
            items = _weight(model, "items", pl)
            score = lambda ids: _take(items, ids, bag_fn) @ u
    elif isinstance(model, DIEN):
        states = model.interest_states(model.history(user, bag_fn, pl),
                                       pl)                        # (1,S,H)

        def score(ids):
            cc = ids.shape[0]
            target = _item_take(model, ids, pl, bag_fn)
            interest = model.evolve(
                states.expand(cc, *states.shape[1:]), target,
                user["hist_mask"].expand(cc, states.shape[1]), pl)
            return model.head(interest, target,
                              user["dense"].expand(cc, -1), pl)
    else:
        rows = cfg.vocab_sizes[0]
        sparse = user["sparse_ids"]                               # (1, F, hot)
        user_emb = table_lookup(model, "tables", sparse, pl,
                                 bag_fn or ops.embedding_bag)
        axes = pl.rows_axes("tables") if pl is not None else None

        def score(ids):
            cc = ids.shape[0]
            ids = ids % rows
            sp = sparse.repeat(cc, 1, 1)
            sp[:, 0, :] = ids[:, None]
            # bag semantics: the candidate id repeated in each slot
            if axes is not None:
                cand = tp_multifeature_bag(
                    model.tables[:1], ids.to(torch.int32).reshape(cc, 1, 1),
                    pl.mesh, rows=rows, axes=axes)[:, 0]          # (cc, D)
            else:
                cand = _take(_weight(model, "tables", pl)[0], ids,
                             bag_fn)                              # (cc, D)
            if cfg.multi_hot > 1:
                cand = cand * cfg.multi_hot
            emb = torch.cat([cand[:, None], user_emb[:, 1:].expand(
                cc, cfg.n_sparse - 1, cfg.embed_dim)], dim=1)
            return model({"sparse_ids": sp,
                          "dense": user["dense"].expand(cc, -1)},
                         bag_fn=bag_fn, emb=emb, ctx=ctx)
    out = torch.cat([score(ids) for ids in cand_ids.reshape(chunks, -1)])
    return coll.gather_slices(out, group)


# ------------------------------------------------------ numpy exchange ---
def tree_from_named(named: Dict[str, object]) -> dict:
    """{module name: x} -> the JAX layout (parameters and optimizer state
    alike): a dotted name is a path of the tree, a numbered child an
    entry of a tuple (`cin.0` -> `cin[0]`, `blocks.1.wqkv` ->
    `blocks[1]["wqkv"]`), and an `nn.Linear`'s `<stack>.<i>.weight` /
    `.bias` become `<stack>[i]["w"]`, transposed, / `["b"]`."""
    root: dict = {}
    for name, x in named.items():
        path = name.split(".")
        if len(path) >= 3 and path[-2].isdigit() \
                and path[-1] in ("weight", "bias"):
            x = transpose(x) if path[-1] == "weight" else x
            path[-1] = path[-1][0]
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x

    def tuples(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(tuples(node[str(i)]) for i in range(len(node)))
        return {k: tuples(v) for k, v in node.items()}
    return tuples(root)


def named_from_tree(tree: dict) -> Dict[str, object]:
    """The inverse of `tree_from_named`: a dict of exactly `w` and `b`
    inside a tuple is an `nn.Linear`."""
    named: Dict[str, object] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            if set(node) == {"w", "b"} and prefix and prefix[-1].isdigit():
                named[".".join(prefix + ["weight"])] = transpose(node["w"])
                named[".".join(prefix + ["bias"])] = node["b"]
                return
            for k, v in node.items():
                walk(v, prefix + [k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        else:
            named[".".join(prefix)] = node
    walk(tree, [])
    return named


def params_from_numpy(params: dict) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy parameters -> the model's `state_dict()` (CPU
    tensors; `load_state_dict` copies them to the model's device)."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in named_from_tree(params).items()}


def params_to_numpy(model: nn.Module) -> dict:
    """The model's parameters as JAX-layout numpy arrays."""
    return tree_from_named({k: p.detach().cpu().numpy()
                            for k, p in model.named_parameters()})
