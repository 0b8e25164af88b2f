"""Flat-npz checkpoints of params trees plus JSON metadata (port of
``repro/checkpoint/ckpt.py``), in the reference's format: one npz entry
a leaf, dict keys joined by "/", list items as "#i", the metadata in a
``.json`` beside the file. A file written by either package loads in the
other key for key.

A bf16 leaf is written as the reference writes it, an ``ml_dtypes``
bfloat16 array (its bytes under the numpy descr '<V2'); without
``ml_dtypes`` saving one raises. Reading gives a 2-byte void array for
such a leaf in both packages; the port reads it back as bf16.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _to_numpy(t, key):
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError:
        raise ValueError(f"checkpoint leaf {key!r} is bfloat16, which numpy holds only "
                         f"through ml_dtypes, and ml_dtypes is not installed") from None
    return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)


def _from_numpy(a, device):
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:       # a bf16 leaf
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}"))
    else:
        out[prefix] = tree
    return out


def _resplit(seg):
    out = []
    while "#" in seg:
        head, _, rest = seg.partition("#")
        num, _, seg2 = rest.partition("/")
        if head:
            out.append(head)
        out.append(("#", int(num)))
        seg = seg2
        if not seg:
            return out
    out.append(seg)
    return out


def _listify(node):
    if isinstance(node, dict):
        keys = list(node.keys())
        if keys and all(isinstance(k, tuple) and k[0] == "#" for k in keys):
            return [_listify(node[("#", i)]) for i in range(max(k[1] for k in keys) + 1)]
        return {k: _listify(v) for k, v in node.items()}
    return node


def _unflatten(flat):
    tree = {}
    for key, val in flat.items():
        parts = [p for seg in key.split("/") for p in _resplit(seg)]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(tree)


def save_checkpoint(path: str, tree, meta: dict | None = None):
    """Write ``tree`` (nested dicts and lists of tensors or arrays) to
    ``path`` (".npz" appended if missing), and ``meta`` to the ".json"
    beside it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v, k) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in _flatten(tree).items()}
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    if meta is not None:
        with open(path.rsplit(".npz", 1)[0] + ".json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str, device="cuda"):
    """The tree of ``save_checkpoint`` (either package's), its leaves as
    tensors on ``device``."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        flat = {k: _from_numpy(z[k], device) for k in z.files}
    return _unflatten(flat)
