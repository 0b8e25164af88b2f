"""Fleet models whose masked matmuls run through the port's kernels (port of
``repro/models/kernel_models.py``).

``KernelMLP`` and ``KernelAttnClassifier`` keep the reference's contract:

  init(seed, device)            -> params, the reference's keys and shapes
  apply(params, x)              -> logits, dense (the server's eval)
  kernel_masks(mask_tree)       -> {"group": per-unit 0/1 vector}
  apply_kernels(params, x, km)  -> logits through the masked kernels

``apply_kernels`` takes the fleet's client axis explicitly where the
reference runs under ``jax.vmap``: params leaves are (C, ...), x is
(C, B, 28, 28, 1) and each ``km[group]`` is (C, units). The FFN hidden
layer goes through ``ops.masked_ffn_train`` and the attention's Q/K/V and O
through ``ops.masked_head_proj`` / ``ops.masked_head_merge``, so each
kernel launches once per call for the whole cohort. On params already
masked by ``submodel.apply_mask`` ``apply_kernels`` equals ``apply`` (the
skipped activations are act(0) = 0, a dropped head's output is 0). The
encoder, embedding and head matmuls stay ``torch.bmm``, as the reference
leaves them outside any Pallas call.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def _dense(gen, device, fan_in, *shape):
    """N(0, 1/fan_in) weights of ``shape``, drawn on the CPU from ``gen``."""
    w = torch.randn(shape, generator=gen) * (1.0 / math.sqrt(fan_in))
    return w.to(device)


def _flat(x):
    """(..., B, 28, 28, 1) -> (..., B, 784), channel-fastest as in JAX."""
    return x.reshape(*x.shape[:-3], -1)


class KernelMLP:
    """Flatten -> encode(64) -> masked FFN 64->1024->64 -> linear head.

    The FFN hidden layer (1024 = 8 x 128 blocks, gelu, no biases) is the
    droppable group; encoder and head are transferred whole. Sized for the
    FEMNIST stand-in (28x28x1, 62 classes)."""
    num_classes = 62
    input_shape = (28, 28, 1)
    d = 64
    hidden = 1024

    UNIT_SPECS = [
        {"name": "ffn", "size": 1024,
         "out": [("ffn/w_in", 1, 1)],
         "in": [("ffn/w_out", 0, 1)]},
    ]

    @staticmethod
    def init(seed: int = 0, device="cuda"):
        """Random params from a seeded CPU ``torch.Generator`` (the same
        values on any device); fp32, the reference's scales and keys."""
        gen = torch.Generator().manual_seed(seed)
        d, Fh = KernelMLP.d, KernelMLP.hidden
        dense = functools.partial(_dense, gen, device)
        return {"enc": dense(784, 784, d),
                "ffn": {"w_in": dense(d, d, Fh), "w_out": dense(Fh, Fh, d)},
                "out": {"w": dense(d, d, 62),
                        "b": torch.zeros(62, dtype=torch.float32,
                                         device=device)}}

    @staticmethod
    def apply(params, x):
        z = _flat(x) @ params["enc"]
        h = (F.gelu(z @ params["ffn"]["w_in"], approximate="tanh")
             @ params["ffn"]["w_out"])
        return h @ params["out"]["w"] + params["out"]["b"]

    @staticmethod
    def kernel_masks(mask_tree):
        """Dense keep-mask tree -> per-neuron 0/1 vector (a w_in column is 1
        iff its neuron is kept); (C, F) for a stacked tree."""
        return {"ffn": mask_tree["ffn"]["w_in"].amax(dim=-2)}

    @staticmethod
    def apply_kernels(params, x, kmasks):
        z = torch.bmm(_flat(x), params["enc"])           # (C, B, d)
        C, B = z.shape[:2]
        rm = kmasks["ffn"][:, None, :].expand(C, B, -1)
        h = ops.masked_ffn_train(z, params["ffn"]["w_in"],
                                 params["ffn"]["w_out"], rm, act="gelu")
        return torch.baddbmm(params["out"]["b"][:, None, :], h,
                             params["out"]["w"])


class KernelAttnClassifier:
    """Patchify -> embed -> head-masked MHA -> block-masked FFN -> head.

    28x28 images become 49 patches of 16 pixels; one pre-norm-free
    transformer block with H=4 heads (hd=16, heads contiguous, head-dim
    fastest) and a 64->256->64 gelu FFN (2 x 128 blocks), mean-pooled into
    a linear classifier. Two droppable groups: "heads" (unit-major tile =
    -16) and "ffn"."""
    num_classes = 62
    input_shape = (28, 28, 1)
    d = 64
    n_heads = 4
    head_dim = 16
    hidden = 256

    UNIT_SPECS = [
        {"name": "heads", "size": 4,
         "out": [("attn/wq", 1, -16), ("attn/wk", 1, -16),
                 ("attn/wv", 1, -16)],
         "in": [("attn/wo", 0, -16)]},
        {"name": "ffn", "size": 256,
         "out": [("ffn/w_in", 1, 1)],
         "in": [("ffn/w_out", 0, 1)]},
    ]

    @staticmethod
    def _patches(x):
        """(..., B, 28, 28, 1) -> (..., B, 49, 16): 7x7 grid of 4x4 patches,
        as the reference's reshape(B, 7, 4, 7, 4).transpose(0, 1, 3, 2, 4)."""
        lead = x.shape[:-3]
        p = x.reshape(*lead, 7, 4, 7, 4).transpose(-3, -2)
        return p.reshape(*lead, 49, 16)

    @staticmethod
    def init(seed: int = 0, device="cuda"):
        """Random params from a seeded CPU ``torch.Generator`` (the same
        values on any device); fp32, the reference's scales and keys."""
        gen = torch.Generator().manual_seed(seed)
        d, Fh = KernelAttnClassifier.d, KernelAttnClassifier.hidden
        dense = functools.partial(_dense, gen, device)
        return {"embed": dense(16, 16, d),
                "attn": {"wq": dense(d, d, d), "wk": dense(d, d, d),
                         "wv": dense(d, d, d), "wo": dense(d, d, d)},
                "ffn": {"w_in": dense(d, d, Fh), "w_out": dense(Fh, Fh, d)},
                "out": {"w": dense(d, d, 62),
                        "b": torch.zeros(62, dtype=torch.float32,
                                         device=device)}}

    @staticmethod
    def _dense_attn(p, e):
        cls = KernelAttnClassifier
        B, S, d = e.shape
        H, hd = cls.n_heads, cls.head_dim
        x2 = e.reshape(B * S, d)
        q = (x2 @ p["wq"]).reshape(B, S, H, hd)
        k = (x2 @ p["wk"]).reshape(B, S, H, hd)
        v = (x2 @ p["wv"]).reshape(B, S, H, hd)
        s = torch.einsum("bqhe,bkhe->bhqk", q, k) * (1.0 / math.sqrt(hd))
        causal = torch.ones(S, S, dtype=torch.bool, device=e.device).tril()
        s = s.masked_fill(~causal, -1e30)
        probs = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhqk,bkhe->bqhe", probs, v).reshape(B * S, H * hd)
        return (ctx @ p["wo"]).reshape(B, S, d)

    @staticmethod
    def apply(params, x):
        """Dense logits (B, 62) of a (B, 28, 28, 1) batch: the server's
        evaluation."""
        cls = KernelAttnClassifier
        e = cls._patches(x) @ params["embed"]
        h = e + cls._dense_attn(params["attn"], e)
        B, S, d = h.shape
        f = (F.gelu(h.reshape(B * S, d) @ params["ffn"]["w_in"],
                    approximate="tanh") @ params["ffn"]["w_out"]).reshape(B, S, d)
        h = h + f
        return h.mean(dim=1) @ params["out"]["w"] + params["out"]["b"]

    @staticmethod
    def kernel_masks(mask_tree):
        """Dense keep-mask tree -> {"heads": (C, 4), "ffn": (C, 256)} 0/1.
        A head is kept iff any of its wq columns is; unit-major layout
        (head-dim fastest), so columns group as (H, hd)."""
        cls = KernelAttnClassifier
        col = mask_tree["attn"]["wq"].amax(dim=-2)
        heads = col.reshape(*col.shape[:-1], cls.n_heads, cls.head_dim).amax(-1)
        return {"heads": heads, "ffn": mask_tree["ffn"]["w_in"].amax(dim=-2)}

    @staticmethod
    def apply_kernels(params, x, kmasks):
        cls = KernelAttnClassifier
        p = cls._patches(x)                                 # (C, B, 49, 16)
        C, B, S = p.shape[:3]
        e = torch.bmm(p.reshape(C, B * S, 16), params["embed"])   # (C, B·S, d)
        at = params["attn"]
        a = ops.masked_attention(e.reshape(C, B, S, cls.d), at["wq"], at["wk"],
                                 at["wv"], at["wo"], kmasks["heads"],
                                 cls.n_heads)
        h = e + a.reshape(C, B * S, cls.d)
        rm = kmasks["ffn"][:, None, :].expand(C, B * S, -1)
        h = h + ops.masked_ffn_train(h, params["ffn"]["w_in"],
                                     params["ffn"]["w_out"], rm, act="gelu")
        pooled = h.reshape(C, B, S, cls.d).mean(dim=2)       # (C, B, d)
        return torch.baddbmm(params["out"]["b"][:, None, :], pooled,
                             params["out"]["w"])


KERNEL_MODELS = {"kernel_mlp": KernelMLP,
                 "kernel_attn": KernelAttnClassifier}
