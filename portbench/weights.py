"""Seeded weights of a configuration, made by the benchmark.

The layout is the program's parameter tree (params stacked over a
leading ``layers`` dim, keyed as ``models/api.specs`` keys them), worked
out here from the configuration file; the harness checks it against the
program's own layout before a run. The values are the benchmark's:
one generator on the device seeded with the run's seed draws every
normal leaf in sorted path order, a few large draws a leaf, in the type
the model is served in. The same seed gives the same weights: the plain
reference of a training cell makes them again after the window, and
that of a serving cell reads the tensors the benchmark made once their
``fingerprint`` shows them unchanged.
"""
from __future__ import annotations

import math

import torch

from portbench.flops import widths

STD = 0.02
DRAW = 1 << 28      # elements one draw fills


def layout(cfg: dict) -> dict:
    """{dotted path: (shape, init)} with init ``("normal", std)``,
    ``("ones",)``."""
    w = widths(cfg)
    d, f, v, L, h, kv, hd = (w[k] for k in ("d", "f", "v", "L", "h", "kv",
                                             "hd"))
    out_std = STD / math.sqrt(2 * L)
    n = ("normal", STD)
    out = {"embed.tok": ((v, d), n)}
    if not w["tied"]:
        out["embed.out"] = ((d, v), n)
    layernorm = cfg.get("norm_type") == "layer_norm"
    for norm in ("ln_f", "layers.ln1", "layers.ln2"):
        lead = () if norm == "ln_f" else (L,)
        out[f"{norm}.scale"] = (lead + (d,), ("ones",))
        if layernorm:
            out[f"{norm}.bias"] = (lead + (d,), n)
    a = "layers.attn."
    out[a + "wq"] = ((L, d, h, hd), n)
    out[a + "wk"] = ((L, d, kv, hd), n)
    out[a + "wv"] = ((L, d, kv, hd), n)
    out[a + "wo"] = ((L, h, hd, d), ("normal", out_std))
    if w["bias"]:
        out[a + "bq"] = ((L, h, hd), n)
        out[a + "bk"] = ((L, kv, hd), n)
        out[a + "bv"] = ((L, kv, hd), n)
    if w["e"]:
        m, e = "layers.moe.", w["e"]
        out[m + "router"] = ((L, d, e), n)
        out[m + "wi"] = ((L, e, d, f), n)
        out[m + "wg"] = ((L, e, d, f), n)
        out[m + "wo"] = ((L, e, f, d), ("normal", out_std))
    elif w["gated"]:
        m = "layers.mlp."
        out[m + "wi"] = ((L, d, f), n)
        out[m + "wg"] = ((L, d, f), n)
        out[m + "wo"] = ((L, f, d), ("normal", out_std))
    else:
        m = "layers.mlp."
        out[m + "wi"] = ((L, d, f), n)
        out[m + "bi"] = ((L, f), n)
        out[m + "wo"] = ((L, f, d), ("normal", out_std))
        out[m + "bo"] = ((L, d), n)
    return dict(sorted(out.items()))


def dtype_of(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cfg["torch_dtype"]]


def nest(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        p = f"{prefix}.{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(flatten(tree[k], p))
        else:
            out[p] = tree[k]
    return out


def make(cfg: dict, seed: int, device, dtype=None) -> dict:
    """{path: tensor} drawn from ``seed`` on ``device``."""
    dtype = dtype or dtype_of(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out = {}
    for path, (shape, init) in layout(cfg).items():
        if init[0] == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=device)
            continue
        x = torch.empty(math.prod(shape), dtype=dtype, device=device)
        for lo in range(0, x.numel(), DRAW):
            x[lo:lo + DRAW].normal_(0.0, init[1], generator=gen)
        out[path] = x.view(shape)
    return out


def fingerprint(flat: dict) -> dict:
    """{path: (sum, sum of squares)} in f64: the weights as made, so that
    a reference that reads them after the window can show that the run
    left them as they were."""
    out = {}
    for p, t in flat.items():
        v, s, q = t.reshape(-1), 0.0, 0.0
        for lo in range(0, v.numel(), DRAW):
            c = v[lo:lo + DRAW].double()
            s += float(c.sum())
            q += float(c.square().sum())
        out[p] = (s, q)
    return out
