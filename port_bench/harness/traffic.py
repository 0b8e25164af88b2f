"""The one traffic generator: it reads a traffic file's parameters and the
seed, and makes every input of a run. The same seed gives the same inputs.

Training: the synthetic LM batches of the program's ``launch/train.py``
(``synth_batch``, copied here, not imported): per batch, ``batch`` rows of
``seq + 1`` uniform draws from [0, vocab_drawn), cumulatively summed modulo
vocab_drawn, so that a token predicts the next; tokens are the first seq,
targets the last seq.

Serving: a fixed cohort of clients, each with a rate (1.0 is the full
model) and, below 1.0, a block keep-mask of round(blocks * rate) of each
layer's 128-unit blocks drawn from the seed. A wave is one request a
client, submitted in one order; a window is a fixed number of whole waves,
ceil(seconds / wave_seconds), so that its work does not hang on the host's
speed. Each wave draws its prompt and generation lengths from the seed,
uniform over each range and stratified: one draw in each of n equal parts
of the range for n clients, so that every wave of every seed does about the
same work, and the seed decides the lengths, their pairing and their order.
The seed also draws the prompts' tokens, the masks, and which client sends
at each place of the order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 128


def _rng(seed: int, *salt: int) -> np.random.RandomState:
    return np.random.RandomState(np.random.SeedSequence([seed % (1 << 63), *salt])
                                 .generate_state(1, np.uint32)[0])


class TrainFeed:
    """Batches {'tokens', 'targets'} (batch, seq) int32, one a call."""

    def __init__(self, traffic: dict, seed: int, device):
        self.t, self.device = traffic, device
        self.rng = _rng(seed, 1)

    def next(self):
        t = self.t
        v = t["vocab_drawn"]
        base = self.rng.randint(0, v, size=(t["batch"], t["seq"] + 1), dtype=np.int32)
        tokens = (np.cumsum(base, axis=1) % v).astype(np.int32)
        return {"tokens": torch.from_numpy(tokens[:, :-1].copy()).to(self.device),
                "targets": torch.from_numpy(tokens[:, 1:].copy()).to(self.device)}


def rows_differ(batch) -> bool:
    t = batch["tokens"].cpu()
    return len({tuple(r.tolist()) for r in t}) == t.shape[0]


# ---------------------------------------------------------------------------
# serving

def cohort(traffic: dict, c: dict, seed: int):
    """[(client, rate, keep)] where keep is None (full model) or a (L, F)
    float32 0/1 tensor: round(blocks * rate) blocks a layer."""
    L, F = c["num_hidden_layers"], c["intermediate_size"]
    nb = F // BLOCK
    rng = _rng(seed, 2)
    out = []
    for group in traffic["cohort"]:
        for _ in range(group["clients"]):
            r = group["rate"]
            keep = None
            if r < 1.0:
                k = max(1, int(round(nb * r)))
                blocks = np.zeros((L, nb), np.float32)
                for layer in range(L):
                    blocks[layer, rng.choice(nb, size=k, replace=False)] = 1.0
                keep = torch.from_numpy(np.repeat(blocks, BLOCK, axis=1))
            out.append((len(out), r, keep))
    return out


def _stratified(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """n integers from [lo, hi], one uniform draw in each of n equal parts."""
    edges = np.linspace(lo, hi + 1, n + 1)
    return np.minimum(np.floor(edges[:-1] + rng.random_sample(n) * np.diff(edges)),
                      hi).astype(np.int64)


def waves(traffic: dict, seconds: float) -> int:
    """Whole waves a window of ``seconds`` sends."""
    return max(1, math.ceil(seconds / traffic["wave_seconds"]))


def wave(traffic: dict, c: dict, seed: int, number: int):
    """[(client, prompt tokens (L,) int64, gen_len)] of wave ``number``, in
    submission order."""
    rng = _rng(seed, 3, number)
    n = sum(g["clients"] for g in traffic["cohort"])
    prompts = rng.permutation(_stratified(rng, *traffic["prompt_len"], n))
    gens = rng.permutation(_stratified(rng, *traffic["gen_len"], n))
    clients = rng.permutation(n)
    vocab = traffic.get("vocab_drawn", c["vocab_size"])
    return [(int(client), rng.randint(0, vocab, size=int(p)).astype(np.int64), int(g))
            for client, p, g in zip(clients, prompts, gens)]


def sample(rng_seed: int, finished, k: int):
    """k of the finished requests, drawn from the seed, the longest (prompt
    and generation together) always among them."""
    order = sorted(range(len(finished)),
                   key=lambda i: -(len(finished[i]["prompt"]) + len(finished[i]["out"])))
    rest = order[1:]
    rng = _rng(rng_seed, 4)
    pick = [order[0]] + [rest[i] for i in rng.permutation(len(rest))[:k - 1]]
    return [finished[i] for i in sorted(pick)]
