"""Fleet models whose masked matmuls run through the port's kernels (port of
``repro/models/kernel_models.py``).

``KernelMLP`` keeps the reference's contract:

  init(seed, device)            -> params, the reference's keys and shapes
  apply(params, x)              -> logits, dense (the server's eval)
  kernel_masks(mask_tree)       -> {"ffn": per-neuron 0/1 vector}
  apply_kernels(params, x, km)  -> logits through the masked-FFN kernel

``apply_kernels`` takes the fleet's client axis explicitly where the
reference runs under ``jax.vmap``: params leaves are (C, ...), x is
(C, B, 28, 28, 1) and ``km["ffn"]`` is (C, F). The hidden layer goes
through ``ops.masked_ffn_train``, so one forward launch and one dx and one
dW launch cover the whole cohort. On params already masked by
``submodel.apply_mask`` it equals ``apply`` (the skipped activations are
act(0) = 0). The encoder and head matmuls stay ``torch.matmul``, as the
reference leaves them outside any Pallas call.

``KernelAttnClassifier`` waits for the masked-attention kernels B4–B9
(ROADMAP.md queue A).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


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

        def dense(fan_in, *shape):
            w = torch.randn(shape, generator=gen) * (1.0 / math.sqrt(fan_in))
            return w.to(device)
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


KERNEL_MODELS = {"kernel_mlp": KernelMLP}
