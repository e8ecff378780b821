"""GraphSAGE in PyTorch, in the reference's three regimes (port of
repro/models/gnn.py but its multi-device `full_graph_partitioned_loss`,
which waits with distribution: ROADMAP.md queue 1, item 9).

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

_KEYS = ("w_self", "w_neigh", "b")


class SageLayer(nn.Module):
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


def init_params(cfg: GNNConfig, d_feat: int, *, seed: int = 0,
                device="cuda") -> GraphSAGE:
    """A GraphSAGE with random weights drawn on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return GraphSAGE(cfg, d_feat, device=device, generator=gen)


def _sage_combine(h_self, h_neigh_proj, layer: SageLayer, *, final: bool):
    """h_self @ w_self + (the neighbour term, already projected) + b, then
    ReLU and an L2 normalisation unless final."""
    out = torch.matmul(h_self, layer.w_self) + h_neigh_proj + layer.b
    if not final:
        out = torch.relu(out)
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        # L2-normalise as in the paper (Hamilton et al. 2017, Alg. 1 l. 7)
        out = out / torch.clamp(norm, min=1e-6)
    return out


def minibatch_forward(model: GraphSAGE, x0, neigh1, neigh2, *,
                      agg_fn: Optional[Callable] = None):
    """Dense-fanout 2-layer GraphSAGE -> logits (B, C).

    x0 (B, d) seed features, neigh1 (B, F1, d), neigh2 (B, F1, F2, d).
    `agg_fn(neigh (N, F, d), w (d, h)) -> (N, h)` replaces the kernel op
    (a comparison against the plain version on the card uses it)."""
    agg_fn = agg_fn or ops.sage_aggregate
    l1, l2 = model.layers
    b, f1, f2, d = neigh2.shape
    # layer 1 at the depth-1 frontier: aggregate 2-hop into 1-hop nodes
    n2 = agg_fn(neigh2.reshape(b * f1, f2, d), l1.w_neigh).view(b, f1, -1)
    h1 = _sage_combine(neigh1, n2, l1, final=False)
    # layer 1 at the seeds themselves (aggregate 1-hop raw features)
    h0 = _sage_combine(x0, agg_fn(neigh1, l1.w_neigh), l1, final=False)
    # layer 2 at the seeds: aggregate 1-hop hidden into seeds
    return _sage_combine(h0, agg_fn(h1, l2.w_neigh), l2, final=True)


def minibatch_nll(model: GraphSAGE, batch: Dict[str, torch.Tensor],
                  **kw) -> torch.Tensor:
    """Per-seed negative log-likelihood (B,) f32."""
    logits = minibatch_forward(model, batch["x0"], batch["neigh1"],
                               batch["neigh2"], **kw)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None])[:, 0]


def minibatch_loss(model: GraphSAGE, batch: Dict[str, torch.Tensor], **kw):
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
                       plan: segment.SegmentPlan) -> torch.Tensor:
    """x: (N, d) node features; plan: `graph_plan` of the edges. Returns
    (N, n_classes) logits."""
    h = x
    n_layers = len(model.layers)
    for l, layer in enumerate(model.layers):
        agg = _aggregate(h, plan, model.cfg.aggregator)
        h = _sage_combine(h, torch.matmul(agg, layer.w_neigh), layer,
                          final=(l == n_layers - 1))
    return h


def _plan_of(batch: Dict[str, torch.Tensor]) -> segment.SegmentPlan:
    if "plan" in batch:
        return batch["plan"]
    return graph_plan(batch["edge_src"], batch["edge_dst"],
                      batch["x"].shape[0])


def full_graph_nll(model: GraphSAGE, batch: Dict[str, torch.Tensor]):
    """Per-node negative log-likelihood (N,) f32 and its mask (N,) f32
    (1 where the label is >= 0). batch: x (N, d), labels (N,) and either
    edge_src / edge_dst (E,) or their `plan` (the driver builds it once
    for the graph)."""
    logits = full_graph_forward(model, batch["x"], _plan_of(batch))
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, torch.clamp(labels, min=0)[:, None])[:, 0]
    return nll, mask


def full_graph_loss(model: GraphSAGE, batch: Dict[str, torch.Tensor]):
    """Mean NLL over the labelled nodes (labels < 0 masked out)."""
    nll, mask = full_graph_nll(model, batch)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
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
                           node_mask) -> torch.Tensor:
    """x: (G, N, d); edges (G, E) int, padded (pad edges 0 -> 0);
    node_mask: (G, N). Returns graph-level logits (G, C): each graph's
    masked mean of its nodes' logits."""
    g, n, d = x.shape
    h = full_graph_forward(model, x.reshape(g * n, d),
                           batched_plan(edge_src, edge_dst, n))
    h = h.reshape(g, n, -1)
    denom = torch.clamp(torch.sum(node_mask, dim=1), min=1.0)
    return torch.sum(h * node_mask[..., None], dim=1) / denom[:, None]


def batched_graphs_nll(model: GraphSAGE,
                       batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-graph negative log-likelihood (G,) f32."""
    logits = batched_graphs_forward(model, batch["x"], batch["edge_src"],
                                    batch["edge_dst"], batch["node_mask"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None])[:, 0]


def batched_graphs_loss(model: GraphSAGE, batch: Dict[str, torch.Tensor]):
    loss = batched_graphs_nll(model, batch).mean()
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
