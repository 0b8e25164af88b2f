"""The paper's evaluation models (port of ``repro/models/small.py``).

CNN (FEMNIST), VGG-9 (CIFAR10), 2-layer LSTM (Shakespeare) — the model
families of the paper's §6 — and the population-scale probe MLP. Each
model keeps the reference's contract:

  init(seed, device) -> params, the reference's keys, shapes and layouts
  apply(params, x)   -> logits
  UNIT_SPECS         -> droppable neuron groups for core/submodel.py

Layouts are the reference's, because the unit specs name their axes:
images are NHWC and conv weights HWIO in the tree (a conv group's
producers are axis 3, its consumers axis 2). A conv runs as torch's NCHW /
OIHW convolution, permuted at the call. The conv->FC flatten is
channel-fastest (NHWC order), which the tile factors 49 (7x7) and 16 (4x4)
of the FC consumer rows depend on.

``apply`` takes one client's params; the dense fleet (fl/fleet.py) runs
it under ``torch.func.vmap`` over the cohort's stacked params. The LSTM
reads its hidden size from ``U``, so physically extracted sub-models run.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


def _dense(gen, device, fan_in, *shape):
    """N(0, 1/fan_in) weights of ``shape``, drawn on the CPU from ``gen``."""
    w = torch.randn(shape, generator=gen) * (1.0 / math.sqrt(fan_in))
    return w.to(device)


def _zeros(device, n):
    return torch.zeros(n, dtype=torch.float32, device=device)


def _conv(x, w, b):
    """SAME convolution at stride 1: x NCHW, w HWIO, b (O,)."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding="same")


def _pool(x):
    """2x2 max pool, stride 2, VALID (NCHW)."""
    return F.max_pool2d(x, 2, 2)


def _flatten_nhwc(x):
    """(B, C, H, W) -> (B, H*W*C), channel-fastest as the reference's NHWC
    reshape."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# FEMNIST CNN: 2x [5x5 conv + 2x2 maxpool], FC-120, softmax-62 (paper §6)

class FemnistCNN:
    num_classes = 62
    input_shape = (28, 28, 1)

    UNIT_SPECS = [
        {"name": "conv1", "size": 16,
         "out": [("conv1/w", 3, 1), ("conv1/b", 0, 1)],
         "in": [("conv2/w", 2, 1)]},
        {"name": "conv2", "size": 64,
         "out": [("conv2/w", 3, 1), ("conv2/b", 0, 1)],
         "in": [("fc1/w", 0, 49)]},          # 7x7 spatial positions
        {"name": "fc1", "size": 120,
         "out": [("fc1/w", 1, 1), ("fc1/b", 0, 1)],
         "in": [("out/w", 0, 1)]},
    ]

    @staticmethod
    def init(seed: int = 0, device="cuda"):
        """Random params from a seeded CPU ``torch.Generator`` (the same
        values on any device); fp32, the reference's scales and keys."""
        dense = functools.partial(_dense, torch.Generator().manual_seed(seed),
                                  device)
        return {
            "conv1": {"w": dense(25, 5, 5, 1, 16), "b": _zeros(device, 16)},
            "conv2": {"w": dense(25 * 16, 5, 5, 16, 64),
                      "b": _zeros(device, 64)},
            "fc1": {"w": dense(7 * 7 * 64, 7 * 7 * 64, 120),
                    "b": _zeros(device, 120)},
            "out": {"w": dense(120, 120, 62), "b": _zeros(device, 62)},
        }

    @staticmethod
    def apply(params, x):
        x = x.permute(0, 3, 1, 2)
        x = _pool(F.relu(_conv(x, params["conv1"]["w"], params["conv1"]["b"])))
        x = _pool(F.relu(_conv(x, params["conv2"]["w"], params["conv2"]["b"])))
        x = F.relu(_flatten_nhwc(x) @ params["fc1"]["w"] + params["fc1"]["b"])
        return x @ params["out"]["w"] + params["out"]["b"]


# ---------------------------------------------------------------------------
# VGG-9 for CIFAR10 (paper §6: 6 conv 3x3 [32,32,64,64,128,128] + FC512 + FC256)

class Vgg9:
    num_classes = 10
    input_shape = (32, 32, 3)

    _CONVS = [("c1a", 3, 32), ("c1b", 32, 32), ("c2a", 32, 64),
              ("c2b", 64, 64), ("c3a", 64, 128), ("c3b", 128, 128)]

    UNIT_SPECS = (
        [{"name": n, "size": co,
          "out": [(f"{n}/w", 3, 1), (f"{n}/b", 0, 1)],
          "in": [(f"{nx}/w", 2, 1)]}
         for (n, ci, co), (nx, _, _) in zip(_CONVS[:-1], _CONVS[1:])]
        + [{"name": "c3b", "size": 128,
            "out": [("c3b/w", 3, 1), ("c3b/b", 0, 1)],
            "in": [("fc1/w", 0, 16)]},       # 4x4 spatial positions
           {"name": "fc1", "size": 512,
            "out": [("fc1/w", 1, 1), ("fc1/b", 0, 1)],
            "in": [("fc2/w", 0, 1)]},
           {"name": "fc2", "size": 256,
            "out": [("fc2/w", 1, 1), ("fc2/b", 0, 1)],
            "in": [("out/w", 0, 1)]}])

    @staticmethod
    def init(seed: int = 0, device="cuda"):
        dense = functools.partial(_dense, torch.Generator().manual_seed(seed),
                                  device)
        p = {n: {"w": dense(9 * ci, 3, 3, ci, co), "b": _zeros(device, co)}
             for n, ci, co in Vgg9._CONVS}
        p["fc1"] = {"w": dense(4 * 4 * 128, 4 * 4 * 128, 512),
                    "b": _zeros(device, 512)}
        p["fc2"] = {"w": dense(512, 512, 256), "b": _zeros(device, 256)}
        p["out"] = {"w": dense(256, 256, 10), "b": _zeros(device, 10)}
        return p

    @staticmethod
    def apply(params, x):
        x = x.permute(0, 3, 1, 2)
        for i, (n, _, _) in enumerate(Vgg9._CONVS):
            x = F.relu(_conv(x, params[n]["w"], params[n]["b"]))
            if i % 2 == 1:
                x = _pool(x)
        x = F.relu(_flatten_nhwc(x) @ params["fc1"]["w"] + params["fc1"]["b"])
        x = F.relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
        return x @ params["out"]["w"] + params["out"]["b"]


# ---------------------------------------------------------------------------
# Shakespeare 2-layer LSTM classifier, 128 hidden units (paper §6)

class ShakespeareLSTM:
    vocab = 80
    embed_dim = 8
    hidden = 128
    num_classes = 80
    seq_len = 20

    UNIT_SPECS = [
        {"name": "lstm1", "size": 128,
         "out": [("lstm1/W", 1, 4), ("lstm1/U", 1, 4), ("lstm1/b", 0, 4)],
         "in": [("lstm1/U", 0, 1), ("lstm2/W", 0, 1)]},
        {"name": "lstm2", "size": 128,
         "out": [("lstm2/W", 1, 4), ("lstm2/U", 1, 4), ("lstm2/b", 0, 4)],
         "in": [("lstm2/U", 0, 1), ("out/w", 0, 1)]},
    ]

    @staticmethod
    def init(seed: int = 0, device="cuda"):
        dense = functools.partial(_dense, torch.Generator().manual_seed(seed),
                                  device)
        cls = ShakespeareLSTM
        V, E, H = cls.vocab, cls.embed_dim, cls.hidden
        return {
            "embed": dense(E, V, E),
            "lstm1": {"W": dense(E, E, 4 * H), "U": dense(H, H, 4 * H),
                      "b": _zeros(device, 4 * H)},
            "lstm2": {"W": dense(H, H, 4 * H), "U": dense(H, H, 4 * H),
                      "b": _zeros(device, 4 * H)},
            "out": {"w": dense(H, H, V), "b": _zeros(device, V)},
        }

    @staticmethod
    def _lstm(p, xs):
        """xs: (B, S, in) -> (B, S, H); H is read from U, so an extracted
        sub-model runs. Gates split i, f, g, o; the forget gate carries a
        +1.0 bias."""
        H = p["U"].shape[0]
        B, S = xs.shape[:2]
        xw = xs @ p["W"]
        h = c = xs.new_zeros(B, H)
        hs = []
        for t in range(S):
            z = xw[:, t] + h @ p["U"] + p["b"]
            i, f, g, o = z.chunk(4, dim=-1)
            c = (torch.sigmoid(f + 1.0) * c
                 + torch.sigmoid(i) * torch.tanh(g))
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1)

    @staticmethod
    def apply(params, x):
        """x: (B, S) int char ids -> logits for the next char (last
        position)."""
        e = params["embed"][x.long()]
        h = ShakespeareLSTM._lstm(params["lstm1"], e)
        h = ShakespeareLSTM._lstm(params["lstm2"], h)
        return h[:, -1] @ params["out"]["w"] + params["out"]["b"]


# ---------------------------------------------------------------------------
# Population-scale probe model: 32-dim vector in, one droppable hidden layer.

class SynthMLP:
    num_classes = 10
    input_shape = (32,)

    UNIT_SPECS = [
        {"name": "fc1", "size": 64,
         "out": [("fc1/w", 1, 1), ("fc1/b", 0, 1)],
         "in": [("out/w", 0, 1)]},
    ]

    @staticmethod
    def init(seed: int = 0, device="cuda"):
        dense = functools.partial(_dense, torch.Generator().manual_seed(seed),
                                  device)
        return {"fc1": {"w": dense(32, 32, 64), "b": _zeros(device, 64)},
                "out": {"w": dense(64, 64, 10), "b": _zeros(device, 10)}}

    @staticmethod
    def apply(params, x):
        h = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
        return h @ params["out"]["w"] + params["out"]["b"]


MODELS = {"femnist_cnn": FemnistCNN, "cifar_vgg9": Vgg9,
          "shakespeare_lstm": ShakespeareLSTM, "synth_mlp": SynthMLP}
