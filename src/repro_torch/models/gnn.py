"""GraphSAGE in PyTorch, in the reference's three regimes and the
full graph's dst-partitioned form on a mesh (port of
repro/models/gnn.py).

  - minibatch: dense-fanout blocks x0 (B, d), neigh1 (B, F1, d), neigh2
    (B, F1, F2, d) from data/sampler.py through a 2-layer GraphSAGE. Each
    neighbour term `mean(x, axis) @ layer["w_neigh"]` runs through the
    hand-written kernel `ops.sage_aggregate` (forward and backward),
    three calls a forward.
  - full graph: message passing over an edge list, the reference's
    `jnp.take` + `segment_sum` (or `segment_max`), through
    models/segment.py's chunked gather-and-segment-reduce, whose
    `SegmentPlan` of the kept edges and in-degrees is built once per
    graph (`graph_plan`) and reused by every layer and step. Pad edges
    carry dst == n_nodes and are dropped, as the reference's segment
    ops drop them.
  - batched small graphs: the reference `vmap`s the full graph over G
    padded graphs of N nodes; the port runs them as one flat graph of
    G * N nodes, graph g's node ids offset by g * N, then pools each
    graph's masked nodes. Pad edges 0 -> 0 are real messages into node
    0, counted as the reference counts them.

  - the partitioned full graph (`full_graph_partitioned_loss`, on a
    `launch.mesh.Mesh`): each rank owns a node range and the edges whose
    dst falls in it (data/graphs.py `partition_edges`), aggregates into
    its range only, and all-gathers the hidden state between layers;
    the loss is two sums over every rank.

The neighbour projection `agg @ w_neigh` of the last two is a
`torch.matmul`, and so is every `h_self @ w_self`: the JAX package leaves
those products to XLA.

Parameters cross between the packages as numpy in the JAX layout,
`{"layers": ({"w_self": (d_in, d_out), "w_neigh": (d_in, d_out),
"b": (d_out,)}, ...)}`, through `params_from_numpy` / `params_to_numpy`;
the module holds them in that layout (no transpose), named
`layers.<l>.<key>`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.kernels import ops
from repro_torch.models import segment
from repro_torch.models.exchange import generator
from repro_torch.train import collectives as coll

_KEYS = ("w_self", "w_neigh", "b")


class SageLayer(nn.Module):
    """`w_self`, `w_neigh` (d_in, d_out) and `b` (d_out,); `LOGICAL` their
    logical axes (the reference's `init_params`)."""

    LOGICAL = {"w_self": ("fsdp", None), "w_neigh": ("fsdp", None),
               "b": (None,)}

    def __init__(self, d_in: int, d_out: int, *, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()

        def normal():
            t = torch.empty((d_in, d_out), dtype=dtype, device=device)
            with torch.no_grad():
                t.normal_(generator=generator).mul_(d_in ** -0.5)
            return nn.Parameter(t)
        self.w_self = normal()
        self.w_neigh = normal()
        self.b = nn.Parameter(torch.zeros((d_out,), dtype=dtype,
                                          device=device))


class GraphSAGE(nn.Module):
    """Layer l maps dims[l] -> dims[l + 1], dims = [d_feat] + [d_hidden] *
    (n_layers - 1) + [n_classes]."""

    def __init__(self, cfg: GNNConfig, d_feat: int, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dims = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) \
            + [cfg.n_classes]
        dtype = getattr(torch, cfg.param_dtype)
        self.layers = nn.ModuleList(
            SageLayer(dims[i], dims[i + 1], dtype=dtype, device=device,
                      generator=generator) for i in range(cfg.n_layers))

    def param_logical(self) -> dict:
        """{parameter name: the reference's logical axes}."""
        return {f"layers.{l}.{k}": lg for l in range(len(self.layers))
                for k, lg in SageLayer.LOGICAL.items()}


def init_params(cfg: GNNConfig, d_feat: int, *, seed: int = 0,
                device="cuda") -> GraphSAGE:
    """A GraphSAGE with random weights drawn on `device` from `seed`."""
    gen = generator(device, seed)
    return GraphSAGE(cfg, d_feat, device=device, generator=gen)


def _weights(model: GraphSAGE, l: int, pl=None, use: str = "same"):
    """Layer l's (w_self, w_neigh, b): under a placement `pl` (launch/
    programs.Placement) fetched whole, `use` "same" where every model
    rank runs the layer alike, "parts" where each runs its own part (the
    partitioned graph's node range)."""
    layer = model.layers[l]
    if pl is None:
        return layer.w_self, layer.w_neigh, layer.b
    return tuple(pl.param(model, f"layers.{l}.{k}", use) for k in _KEYS)


def _sage_combine(h_self, h_neigh_proj, w_self, b, *, final: bool):
    """h_self @ w_self + (the neighbour term, already projected) + b, then
    ReLU and an L2 normalisation unless final."""
    out = torch.matmul(h_self, w_self) + h_neigh_proj + b
    if not final:
        out = torch.relu(out)
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        # L2-normalise as in the paper (Hamilton et al. 2017, Alg. 1 l. 7)
        out = out / torch.clamp(norm, min=1e-6)
    return out


def minibatch_forward(model: GraphSAGE, x0, neigh1, neigh2, *,
                      agg_fn: Optional[Callable] = None, placement=None):
    """Dense-fanout 2-layer GraphSAGE -> logits (B, C).

    x0 (B, d) seed features, neigh1 (B, F1, d), neigh2 (B, F1, F2, d).
    `agg_fn(neigh (N, F, d), w (d, h)) -> (N, h)` replaces the kernel op
    (a comparison against the plain version on the card uses it). Under
    a `placement` the rows are this data rank's and the weights are
    fetched whole (`w_neigh` into the kernel as it is on one device)."""
    agg_fn = agg_fn or ops.sage_aggregate
    (s1, n1, b1), (s2, n2w, b2) = (_weights(model, l, placement)
                                   for l in range(2))
    b, f1, f2, d = neigh2.shape
    # layer 1 at the depth-1 frontier: aggregate 2-hop into 1-hop nodes
    n2 = agg_fn(neigh2.reshape(b * f1, f2, d), n1).view(b, f1, -1)
    h1 = _sage_combine(neigh1, n2, s1, b1, final=False)
    # layer 1 at the seeds themselves (aggregate 1-hop raw features)
    h0 = _sage_combine(x0, agg_fn(neigh1, n1), s1, b1, final=False)
    # layer 2 at the seeds: aggregate 1-hop hidden into seeds
    return _sage_combine(h0, agg_fn(h1, n2w), s2, b2, final=True)


def minibatch_nll(model: GraphSAGE, batch: Dict[str, torch.Tensor],
                  **kw) -> torch.Tensor:
    """Per-seed negative log-likelihood (B,) f32."""
    logits = minibatch_forward(model, batch["x0"], batch["neigh1"],
                               batch["neigh2"], **kw)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None])[:, 0]


def minibatch_loss(model: GraphSAGE, batch: Dict[str, torch.Tensor], **kw):
    """Mean NLL over the seeds (`kw`: minibatch_forward's)."""
    loss = minibatch_nll(model, batch, **kw).mean()
    return loss, {"xent": loss}


# ---------------------------------------------------------- full graph ---
def graph_plan(edge_src: torch.Tensor, edge_dst: torch.Tensor,
               n_nodes: int) -> segment.SegmentPlan:
    """The edges (messages flow src -> dst) of a graph of n_nodes as a
    SegmentPlan: edges whose dst lies outside [0, n_nodes) dropped, the
    in-degree of each node counted."""
    return segment.segment_plan(edge_src, edge_dst, n_nodes, n_nodes)


def _aggregate(h: torch.Tensor, plan: segment.SegmentPlan, aggregator: str):
    """The reference's neighbour aggregate: max, or the sum, divided by
    the in-degree (at least 1) for mean."""
    if aggregator == "max":
        return segment.segment_max(h, plan)
    agg = segment.segment_sum(h, plan)
    if aggregator == "mean":
        agg = agg / torch.clamp(plan.count.to(h.dtype), min=1.0)[:, None]
    return agg


def full_graph_forward(model: GraphSAGE, x: torch.Tensor,
                       plan: segment.SegmentPlan, placement=None
                       ) -> torch.Tensor:
    """x: (N, d) node features; plan: `graph_plan` of the edges. Returns
    (N, n_classes) logits. Under a `placement` the weights are fetched
    whole and every model rank runs the layers alike."""
    h = x
    n_layers = len(model.layers)
    for l in range(n_layers):
        w_self, w_neigh, b = _weights(model, l, placement)
        agg = _aggregate(h, plan, model.cfg.aggregator)
        h = _sage_combine(h, torch.matmul(agg, w_neigh), w_self, b,
                          final=(l == n_layers - 1))
    return h


def _plan_of(batch: Dict[str, torch.Tensor]) -> segment.SegmentPlan:
    if "plan" in batch:
        return batch["plan"]
    return graph_plan(batch["edge_src"], batch["edge_dst"],
                      batch["x"].shape[0])


def _masked_nll(logits: torch.Tensor, labels: torch.Tensor):
    """Per-node negative log-likelihood (N,) f32 and its mask (N,) f32
    (1 where the label is >= 0)."""
    labels = labels.long()
    mask = (labels >= 0).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, torch.clamp(labels, min=0)[:, None])[:, 0]
    return nll, mask


def full_graph_nll(model: GraphSAGE, batch: Dict[str, torch.Tensor]):
    """Per-node negative log-likelihood (N,) f32 and its mask (N,) f32
    (1 where the label is >= 0). batch: x (N, d), labels (N,) and either
    edge_src / edge_dst (E,) or their `plan` (the driver builds it once
    for the graph)."""
    logits = full_graph_forward(model, batch["x"], _plan_of(batch))
    return _masked_nll(logits, batch["labels"])


def _mean_nll(nll: torch.Tensor, mask: torch.Tensor):
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"xent": loss}


def full_graph_loss(model: GraphSAGE, batch: Dict[str, torch.Tensor]):
    """Mean NLL over the labelled nodes (labels < 0 masked out)."""
    return _mean_nll(*full_graph_nll(model, batch))


# ------------------------------------------------ edge-sharded full graph ---
def edge_shard_plan(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                    n_nodes: int, in_degree: torch.Tensor
                    ) -> segment.SegmentPlan:
    """One data rank's slice of a full graph's edges as a SegmentPlan over
    all n_nodes (pad edges, dst == n_nodes, dropped), its `count` the
    whole graph's in-degree (in_degree (N,) f32), which the mean divides
    by."""
    return graph_plan(edge_src, edge_dst, n_nodes)._replace(
        count=in_degree.to(torch.float32))


def full_graph_edge_sharded_loss(model: GraphSAGE,
                                 batch: Dict[str, torch.Tensor], placement):
    """The reference's default full-graph program (`partitioned` False:
    GSPMD's `full_graph_loss` with the edges over the data axes and the
    nodes, features and labels replicated), this rank's part.

    batch: x (N, d) and labels (N,), whole on every rank; `plan`, this
    data rank's slice of the edges as `edge_shard_plan` makes it (the
    driver builds it once a graph). Each layer segment-sums this rank's
    edges into a whole (N, d) partial, and one sum over the data axes
    completes it (`psum_same`; the hidden state it reads is held alike
    and read for this rank's part, so its gradient is summed over them,
    `same_to_parts`); every model rank runs it alike. The loss is the
    whole graph's masked NLL on every rank. As in the reference the mean
    divides by the whole in-degree; "max" has no edge-sharded form
    here."""
    if model.cfg.aggregator not in ("mean", "sum"):
        raise ValueError(f"the edge-sharded full graph sums its partial "
                         f"aggregates; {model.cfg.aggregator!r} is not a "
                         f"sum")
    group, plan = placement.dpg, batch["plan"]
    h = batch["x"]
    n_layers = len(model.layers)
    for l in range(n_layers):
        w_self, w_neigh, b = _weights(model, l, placement)
        part = segment.segment_sum(coll.same_to_parts(h, group), plan)
        agg = coll.psum_same(part, group)
        if model.cfg.aggregator == "mean":
            agg = agg / torch.clamp(plan.count.to(agg.dtype), min=1.0)[:, None]
        h = _sage_combine(h, torch.matmul(agg, w_neigh), w_self, b,
                          final=(l == n_layers - 1))
    return _mean_nll(*_masked_nll(h, batch["labels"]))


# ------------------------------------------- dst-partitioned full graph ---
def partition_plan(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                   node0: int, n_loc: int, n_pad: int) -> segment.SegmentPlan:
    """One rank's edges (e_loc,) (pad edges -1) as a SegmentPlan into its
    node range [node0, node0 + n_loc): the pad edges dropped (the
    reference multiplies their messages by 0, and counts them 0 in the
    in-degree), the rest read h at src and land at dst - node0."""
    ok = edge_src >= 0
    seg = torch.where(ok, edge_dst.long() - node0,
                      torch.full_like(edge_dst, -1, dtype=torch.long))
    return segment.segment_plan(torch.where(ok, edge_src.long(), 0), seg,
                                n_loc, n_pad)


def full_graph_partitioned_loss(model: GraphSAGE,
                                batch: Dict[str, torch.Tensor], mesh,
                                placement=None):
    """The reference's dst-partitioned message passing, this rank's part.

    Rank k (flat over (pod, data, model), major to minor) owns the nodes
    [k n_loc, (k + 1) n_loc) and the edges of row k of edge_src /
    edge_dst, whose dst falls in them (pad edges src = dst = -1): its
    segment sum lands in its own range. Between layers one all-gather of
    the hidden state over every rank (its backward the matching
    reduce-scatter); the loss is the masked NLL of its label slice,
    numerator and denominator each summed over every rank. As in the
    reference, the neighbours are summed (divided by the in-degree for
    "mean"), whatever other aggregator the config names.

    batch: x (N_pad, d), every rank's; edge_src, edge_dst (n_shards,
    e_loc) int32 and labels (N_pad,) int32 (-1 masked or pad), whole,
    each rank reading its row and slice; `part_plan`, where given, this
    rank's `partition_plan` (the driver builds it once a graph). The
    parameters' gradients are this rank's share: summed over every rank
    they are the loss's. Under a `placement` the weights are fetched
    whole for this rank's part."""
    axes = mesh.axis_names
    n_shards = mesh.size(axes)
    x = batch["x"]
    n_pad = x.shape[0]
    if n_pad % n_shards:
        raise ValueError(f"{n_pad} nodes do not divide over {n_shards} "
                         f"shards")
    n_loc = n_pad // n_shards
    k = mesh.index(axes)
    node0 = k * n_loc
    plan = batch.get("part_plan")
    if plan is None:
        plan = partition_plan(batch["edge_src"][k], batch["edge_dst"][k],
                              node0, n_loc, n_pad)
    group = mesh.all_group
    h_full = x
    n_layers = len(model.layers)
    for l in range(n_layers):
        w_self, w_neigh, b = _weights(model, l, placement, "parts")
        agg = segment.segment_sum(h_full, plan)
        if model.cfg.aggregator == "mean":
            agg = agg / torch.clamp(plan.count.to(agg.dtype), min=1.0)[:, None]
        h_loc = _sage_combine(h_full[node0:node0 + n_loc],
                              torch.matmul(agg, w_neigh), w_self, b,
                              final=(l == n_layers - 1))
        if l < n_layers - 1:
            h_full = coll.all_gather_sum(h_loc, group)
    nll, mask = _masked_nll(h_loc, batch["labels"][node0:node0 + n_loc])
    num = coll.psum_same(torch.sum(nll * mask), group)
    den = coll.psum_same(torch.sum(mask), group)
    loss = num / torch.clamp(den, min=1.0)
    return loss, {"xent": loss}


# ------------------------------------------------ batched small graphs ---
def batched_plan(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                 n_nodes: int) -> segment.SegmentPlan:
    """G graphs' padded edge lists (G, E), node ids local to each graph
    of n_nodes, as one SegmentPlan over G * n_nodes nodes: graph g's ids
    offset by g * n_nodes, an edge whose dst lies outside its graph
    dropped and one whose src does reading NaN, as the reference's
    per-graph take and segment_sum treat them."""
    g = edge_src.shape[0]
    base = torch.arange(g, device=edge_src.device)[:, None] * n_nodes
    src = torch.where(edge_src < 0, edge_src + n_nodes, edge_src)
    src = torch.where((src >= 0) & (src < n_nodes), src + base, g * n_nodes)
    dst = torch.where((edge_dst >= 0) & (edge_dst < n_nodes),
                      edge_dst + base, -1)
    return segment.segment_plan(src.reshape(-1), dst.reshape(-1),
                                g * n_nodes, g * n_nodes)


def batched_graphs_forward(model: GraphSAGE, x, edge_src, edge_dst,
                           node_mask, plan=None, placement=None
                           ) -> torch.Tensor:
    """x: (G, N, d); edges (G, E) int, padded (pad edges 0 -> 0);
    node_mask: (G, N); `plan`, where given, their `batched_plan` (the
    dry run's, made from shapes). Returns graph-level logits (G, C):
    each graph's masked mean of its nodes' logits. `placement`: as
    `full_graph_forward`'s."""
    g, n, d = x.shape
    if plan is None:
        plan = batched_plan(edge_src, edge_dst, n)
    h = full_graph_forward(model, x.reshape(g * n, d), plan, placement)
    h = h.reshape(g, n, -1)
    denom = torch.clamp(torch.sum(node_mask, dim=1), min=1.0)
    return torch.sum(h * node_mask[..., None], dim=1) / denom[:, None]


def batched_graphs_nll(model: GraphSAGE, batch: Dict[str, torch.Tensor],
                       placement=None) -> torch.Tensor:
    """Per-graph negative log-likelihood (G,) f32."""
    logits = batched_graphs_forward(model, batch["x"], batch["edge_src"],
                                    batch["edge_dst"], batch["node_mask"],
                                    batch.get("plan"), placement)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None])[:, 0]


def batched_graphs_loss(model: GraphSAGE, batch: Dict[str, torch.Tensor],
                        placement=None):
    loss = batched_graphs_nll(model, batch, placement).mean()
    return loss, {"xent": loss}


# ------------------------------------------------------ numpy exchange ---
def tree_from_named(named: Dict[str, object]) -> dict:
    """{"layers.<l>.<key>": x} -> the JAX layout {"layers": ({key: x},
    ...)} (for parameters and for optimizer state alike)."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in named)
    return {"layers": tuple({key: named[f"layers.{l}.{key}"]
                             for key in _KEYS} for l in range(n_layers))}


def named_from_tree(tree: dict) -> Dict[str, object]:
    """The inverse of `tree_from_named`."""
    return {f"layers.{l}.{key}": layer[key]
            for l, layer in enumerate(tree["layers"]) for key in _KEYS}


def params_from_numpy(params: dict) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy parameters -> a `GraphSAGE.state_dict()` (CPU
    tensors; `load_state_dict` copies them to the model's device)."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in named_from_tree(params).items()}


def params_to_numpy(model: GraphSAGE) -> dict:
    """The model's parameters as JAX-layout numpy arrays."""
    return tree_from_named({k: p.detach().cpu().numpy()
                            for k, p in model.named_parameters()})
