"""The weights of an MLA + MoE run (DeepSeek-V2's block), made by the
benchmark from ``--seed`` on the device and handed to the program in its
params layout: segment 0 the leading dense layers, segment 1 the MoE
layers, each leaf stacked over its segment's layers. Each (leaf, layer)
has a generator of its own, numbered by the layer's place in the model, so
a reference can make one layer's weights again without the rest.

Every matrix is normal / sqrt(fan_in) in the configuration's weight dtype,
but the router, in float32 as the program keeps it, and the token table,
whose rows are standard normal (fan_in 1). At 1 / sqrt(d) a token's
embedding (norm 1) is lost beside the first attention's output, which at
4096 positions is much the same for every query; every token then routes
to the same few experts and about half the picks overflow their capacity
(48% on one H100 run of the cell). With rows of norm sqrt(d) the token
leads the residual stream, as in a trained model, and the picks spread.
Norm scales are 1, in float32.
"""
from __future__ import annotations

import math

import torch

from harness.weights import DTYPES, _stream, leaves

# (path, fan_in key) of every matrix, in a fixed order: the order numbers
# the generators, so it may only be appended to
MATRICES = (("tok/embed", "one"), ("tok/lm_head", "d"),
            ("mla/wq", "d"), ("mla/w_dkv", "d"), ("mla/w_uk", "lora"),
            ("mla/w_uv", "lora"), ("mla/wo", "hv"),
            ("ffn/w_in", "d"), ("ffn/w_gate", "d"), ("ffn/w_out", "f"),
            ("moe/router", "d"), ("moe/w_in", "d"), ("moe/w_gate", "d"),
            ("moe/w_out", "fe"), ("moe/shared/w_in", "d"), ("moe/shared/w_gate", "d"),
            ("moe/shared/w_out", "fs"))
NORMS = ("norm1/scale", "norm2/scale", "mla/kv_norm")


def dims(c):
    """The sizes the shapes are made of, by the configuration file's keys."""
    return dict(d=c["hidden_size"], f=c["intermediate_size"], V=c["vocab_size"],
                H=c["num_attention_heads"], nope=c["qk_nope_head_dim"],
                rope=c["qk_rope_head_dim"], vd=c["v_head_dim"], lora=c["kv_lora_rank"],
                E=c["n_routed_experts"], fe=c["moe_intermediate_size"],
                fs=c["n_shared_experts"] * c["moe_intermediate_size"],
                dense=c["first_k_dense_replace"], L=c["num_hidden_layers"])


def shapes(c):
    """{path: shape} of one layer's matrices (dense and MoE) and of the
    token tables."""
    z = dims(c)
    d, H = z["d"], z["H"]
    return {"tok/embed": (z["V"], d), "tok/lm_head": (d, z["V"]),
            "mla/wq": (d, H, z["nope"] + z["rope"]), "mla/w_dkv": (d, z["lora"] + z["rope"]),
            "mla/w_uk": (z["lora"], H, z["nope"]), "mla/w_uv": (z["lora"], H, z["vd"]),
            "mla/wo": (H, z["vd"], d),
            "ffn/w_in": (d, z["f"]), "ffn/w_gate": (d, z["f"]), "ffn/w_out": (z["f"], d),
            "moe/router": (d, z["E"]), "moe/w_in": (z["E"], d, z["fe"]),
            "moe/w_gate": (z["E"], d, z["fe"]), "moe/w_out": (z["E"], z["fe"], d),
            "moe/shared/w_in": (d, z["fs"]), "moe/shared/w_gate": (d, z["fs"]),
            "moe/shared/w_out": (z["fs"], d)}


def _fan_in(c, key):
    z = dims(c)
    return {"one": 1, "d": z["d"], "lora": z["lora"], "hv": z["H"] * z["vd"], "f": z["f"],
            "fe": z["fe"], "fs": z["fs"]}[key]


def segments(c):
    """[(segment, first layer, layers, FFN group)]: the dense layers, then
    the MoE layers."""
    z = dims(c)
    return [("seg0", 0, z["dense"], "ffn"), ("seg1", z["dense"], z["L"] - z["dense"], "moe")]


def matrix(c, seed: int, path: str, layer: int, device, dtype):
    """One matrix (a layer's, or a token table with layer 0)."""
    index = [p for p, _ in MATRICES].index(path)
    g = torch.Generator(device=device)
    g.manual_seed(_stream(seed, index, layer))
    w = torch.randn(shapes(c)[path], generator=g, device=device, dtype=dtype)
    return w.mul_(1.0 / math.sqrt(_fan_in(c, dict(MATRICES)[path])))


def _group_paths(group):
    """The matrices and norms of one segment's layers, by path in a layer."""
    mats = [p for p, _ in MATRICES if p.startswith("mla/") or p.startswith(f"{group}/")]
    return mats, list(NORMS)


def make_params(c, seed: int, device, dtype=None):
    """The whole params tree in the program's layout, each stacked leaf
    drawn one layer at a time."""
    dtype = dtype or DTYPES[c["weight_dtype"]]
    z = dims(c)
    tree = {"tok": {"embed": torch.empty(shapes(c)["tok/embed"], device=device, dtype=dtype),
                    "lm_head": torch.empty(shapes(c)["tok/lm_head"], device=device,
                                           dtype=dtype)},
            "final_norm": {"scale": torch.ones(z["d"], device=device)}, "stack": {}}
    for seg, _, R, group in segments(c):
        mats, norms = _group_paths(group)
        unit = {}
        for path in mats:
            dt = torch.float32 if path == "moe/router" else dtype
            _put(unit, path, torch.empty((R,) + shapes(c)[path], device=device, dtype=dt))
        for path in norms:
            n = z["lora"] if path == "mla/kv_norm" else z["d"]
            _put(unit, path, torch.ones(R, n, device=device))
        tree["stack"][seg] = {"l0": unit}
    return fill(tree, c, seed)


def _put(tree, path, t):
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = t


def initial(c, seed: int, path: str, layer: int, like):
    """The seed's value of leaf ``path`` of model layer ``layer`` (0 for a
    token table), in the type and on the device of ``like``."""
    if path.endswith(("/scale", "/kv_norm")):
        return torch.ones_like(like)
    inner = path.split("/l0/", 1)[1] if path.startswith("stack/") else path
    return matrix(c, seed, inner, layer, like.device, like.dtype)


def first_layer(c, path: str) -> int:
    """The model layer of repeat 0 of a stacked leaf."""
    return dims(c)["dense"] if path.startswith("stack/seg1/") else 0


def fill(tree, c, seed: int):
    """Sets every leaf of a params tree to the seed's weights, in place."""
    for path, t in leaves(tree):
        if path.startswith("stack/"):
            for r in range(t.shape[0]):
                t[r].copy_(initial(c, seed, path, first_layer(c, path) + r, t[r]))
        else:
            t.copy_(initial(c, seed, path, 0, t))
    return tree
