"""The weights of a run, drawn on the device from `--seed` by the
benchmark: one generator a leaf (a table's, one a feature), one
`normal_` a part in the dtype the configuration serves them in, then the
scale. The program's parameters are filled with them; the reference
draws the same parts again, alone, once the program's state is freed."""
from __future__ import annotations

import torch

from perfbench.lib.traffic import generator


def draw(seed: int, index: int, part: int, shape, init, dtype, device):
    """Leaf `index`'s part `part` (a feature of a table; 0 otherwise)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if init[0] == "zeros":
        return t.zero_()
    g = generator(device, seed, 7, index, part)
    return t.normal_(generator=g).mul_(init[1])


def _parts(shape, table: bool):
    return (shape[0], tuple(shape[1:])) if table else (1, tuple(shape))


@torch.no_grad()
def fill(model, leaves, tables, seed: int) -> None:
    """The program's parameters (`model.named_parameters()`, named as
    `leaves`) drawn from `seed`."""
    params = dict(model.named_parameters())
    if set(params) != {n for n, _, _ in leaves}:
        raise ValueError(f"the program's leaves {sorted(params)} are not "
                         f"the configuration's {[n for n, _, _ in leaves]}")
    for i, (name, shape, init) in enumerate(leaves):
        p = params[name]
        if tuple(p.shape) != tuple(shape):
            raise ValueError(f"{name}: {tuple(p.shape)} != {tuple(shape)}")
        n, part_shape = _parts(shape, name in tables)
        for j in range(n):
            src = draw(seed, i, j, part_shape, init, p.dtype, p.device)
            (p[j] if name in tables else p).copy_(src)


@torch.no_grad()
def reference_init(leaves, tables, seed: int, dtype, device,
                   rows: dict) -> dict:
    """{leaf: [f32 parts]} as `fill` drew them: a table's parts only at
    `rows[name][f]`, the rows feature f reads."""
    out = {}
    for i, (name, shape, init) in enumerate(leaves):
        n, part_shape = _parts(shape, name in tables)
        parts = []
        for j in range(n):
            t = draw(seed, i, j, part_shape, init, dtype, device)
            if name in tables:
                t = t[rows[name][j]]
            parts.append(t.float())
            del t
        out[name] = parts
    return out
