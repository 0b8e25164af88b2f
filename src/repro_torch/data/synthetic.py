"""Deterministic synthetic stand-ins for FEMNIST / CIFAR10 / Shakespeare.

A numpy copy of ``repro/data/synthetic.py``: the same seed gives the same
arrays bit for bit (tests/test_torch_fl.py).

The container is offline, so we generate classification problems with real
learnable structure (class-conditional prototypes + noise; for the char-LM a
stochastic grammar with per-class transition matrices mirroring Shakespeare's
role-based non-IID split). Accuracy *orderings* between dropout methods are
the reproduction target, not absolute values (DESIGN.md §7).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    name: str
    x: np.ndarray          # inputs
    y: np.ndarray          # int labels
    writer: np.ndarray     # non-IID partition key (writer/class role)
    num_classes: int
    x_test: np.ndarray
    y_test: np.ndarray


def _image_dataset(name, shape, num_classes, n, n_test, n_writers, seed):
    rng = np.random.RandomState(seed)
    protos = rng.randn(num_classes, *shape).astype(np.float32)
    # writer-specific style offsets make the partition genuinely non-IID
    styles = 0.6 * rng.randn(n_writers, *shape).astype(np.float32)

    def gen(m, with_writer=True):
        y = rng.randint(0, num_classes, size=m)
        w = rng.randint(0, n_writers, size=m)
        x = protos[y] + 1.2 * rng.randn(m, *shape).astype(np.float32)
        if with_writer:
            x = x + styles[w]
        return x, y, w
    x, y, w = gen(n)
    xt, yt, _ = gen(n_test)
    return Dataset(name, x, y, w, num_classes, xt, yt)


def _char_dataset(n, n_test, n_roles, seq_len, vocab, seed):
    rng = np.random.RandomState(seed)
    # per-role Markov transition matrices (roles ~ Shakespeare characters)
    base = rng.dirichlet(np.ones(vocab) * 0.1, size=vocab)
    seqs, labels, roles = [], [], []
    mats = []
    for r in range(n_roles):
        perm = rng.permutation(vocab)
        mats.append(base[perm][:, perm])

    def sample(m):
        xs = np.zeros((m, seq_len), np.int32)
        ys = np.zeros((m,), np.int32)
        ws = rng.randint(0, n_roles, size=m)
        for i in range(m):
            T = mats[ws[i]]
            c = rng.randint(vocab)
            for t in range(seq_len):
                xs[i, t] = c
                c = rng.choice(vocab, p=T[c])
            ys[i] = c
        return xs, ys, ws
    x, y, w = sample(n)
    xt, yt, _ = sample(n_test)
    return Dataset("shakespeare", x, y, w, vocab, xt, yt)


def make_dataset(name: str, n: int = 4000, n_test: int = 800,
                 n_partitions: int = 32, seed: int = 0) -> Dataset:
    if name == "femnist":
        return _image_dataset("femnist", (28, 28, 1), 62, n, n_test,
                              n_partitions, seed)
    if name == "cifar10":
        return _image_dataset("cifar10", (32, 32, 3), 10, n, n_test,
                              n_partitions, seed + 1)
    if name == "shakespeare":
        return _char_dataset(n, n_test, n_partitions, seq_len=20, vocab=80,
                             seed=seed + 2)
    if name == "synth":
        # flat 32-dim vectors: the population-scale probe workload — same
        # prototype+style generator, just without image structure
        return _image_dataset("synth", (32,), 10, n, n_test,
                              n_partitions, seed + 3)
    raise ValueError(name)


DATASETS = ("femnist", "cifar10", "shakespeare", "synth")
