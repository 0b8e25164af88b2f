"""The weights of a run, made by the benchmark from ``--seed`` on the device
in the type they are served or trained in, and handed to the program in its
params layout (one segment of ``num_hidden_layers`` stacked layers). Each
(leaf, layer) has a generator of its own, so a reference can make one
layer's weights again without the rest.

Every matrix is normal / sqrt(fan_in), in the configuration's weight
dtype; norm scales are 1 and norm biases 0, in float32, as the program
keeps its vectors.
"""
from __future__ import annotations

import math

import torch

# (path, fan_in key) of every matrix, in a fixed order: the order numbers
# the generators, so it may only be appended to
MATRICES = (("tok/embed", "d"), ("tok/lm_head", "d"),
            ("attn/wq", "d"), ("attn/wk", "d"), ("attn/wv", "d"), ("attn/wo", "q"),
            ("ffn/w_in", "d"), ("ffn/w_gate", "d"), ("ffn/w_out", "f"))

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _stream(seed: int, index: int, layer: int) -> int:
    """A 63-bit generator seed for matrix ``index`` of ``layer``."""
    return (seed * 1_000_003 + index * 10_007 + layer * 101 + 17) % (1 << 63)


def shapes(c):
    """{path: shape} of one layer's matrices and of the token tables."""
    d, f, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    H, KV, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    out = {"tok/embed": (v, d), "tok/lm_head": (d, v),
           "attn/wq": (d, H, hd), "attn/wk": (d, KV, hd), "attn/wv": (d, KV, hd),
           "attn/wo": (H, hd, d), "ffn/w_in": (d, f), "ffn/w_out": (f, d)}
    if c["ffn_kind"] in ("swiglu", "gelu_gated"):
        out["ffn/w_gate"] = (d, f)
    return out


def _fan_in(c, key):
    return {"d": c["hidden_size"], "f": c["intermediate_size"],
            "q": c["num_attention_heads"] * c["head_dim"]}[key]


def matrix(c, seed: int, path: str, layer: int, device, dtype):
    """One matrix (one layer's, or a token table with layer 0)."""
    index = [p for p, _ in MATRICES].index(path)
    fan = dict(MATRICES)[path]
    g = torch.Generator(device=device)
    g.manual_seed(_stream(seed, index, layer))
    w = torch.randn(shapes(c)[path], generator=g, device=device, dtype=dtype)
    return w.mul_(1.0 / math.sqrt(_fan_in(c, fan)))


def norm(c, device, layers=None):
    lead = (layers,) if layers else ()
    p = {"scale": torch.ones(*lead, c["hidden_size"], device=device)}
    if c["norm_kind"] == "layernorm":
        p["bias"] = torch.zeros(*lead, c["hidden_size"], device=device)
    return p


def layer(c, seed: int, r: int, device, dtype):
    """Layer r's params: {'norm1', ['norm2'], 'attn', 'ffn'} (unstacked)."""
    out = {"norm1": norm(c, device), "attn": {}, "ffn": {}}
    if not c["parallel_block"]:
        out["norm2"] = norm(c, device)
    for path in shapes(c):
        group, name = path.split("/")
        if group != "tok":
            out[group][name] = matrix(c, seed, path, r, device, dtype)
    return out


def make_params(c, seed: int, device, dtype=None):
    """The whole params tree in the program's layout: matrices stacked over
    the layers, one layer drawn at a time into the stacked tensor."""
    dtype = dtype or DTYPES[c["weight_dtype"]]
    L = c["num_hidden_layers"]
    stack = {"norm1": norm(c, device, L), "attn": {}, "ffn": {}}
    if not c["parallel_block"]:
        stack["norm2"] = norm(c, device, L)
    for path, shape in shapes(c).items():
        group, name = path.split("/")
        if group != "tok":
            stack[group][name] = torch.empty((L,) + shape, device=device, dtype=dtype)
    tok = {"embed": torch.empty(shapes(c)["tok/embed"], device=device, dtype=dtype),
           "lm_head": torch.empty(shapes(c)["tok/lm_head"], device=device, dtype=dtype)}
    tree = {"tok": tok, "final_norm": norm(c, device), "stack": {"seg0": {"l0": stack}}}
    return fill(tree, c, seed)


def initial(c, seed: int, path: str, layer: int, like):
    """The seed's value of leaf ``path`` (of layer ``layer`` where the leaf
    is stacked), in the type and on the device of ``like``."""
    *_, group, name = path.split("/")
    if name in ("scale", "bias"):
        return (torch.ones_like if name == "scale" else torch.zeros_like)(like)
    return matrix(c, seed, f"{group}/{name}", layer, like.device, like.dtype)


def fill(tree, c, seed: int):
    """Sets every leaf of a params tree to the seed's weights, in place."""
    for path, t in leaves(tree):
        if path.startswith("stack/") and path.rsplit("/", 1)[1] not in ("scale", "bias"):
            for r in range(t.shape[0]):
                t[r].copy_(initial(c, seed, path, r, t[r]))
        else:
            t.copy_(initial(c, seed, path, 0, t))
    return tree


def leaves(tree, prefix=""):
    """[(path, tensor)] of a params tree, depth first in key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]
