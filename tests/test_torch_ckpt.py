"""The port's flat-npz checkpoints against the reference's, on the CPU:
a round trip of a params-and-state tree (dicts, lists, an int32 scalar,
bf16 leaves), and each package reading the other's file key for key with
the same bytes, metadata beside it."""
import json

import numpy as np
import pytest

pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402


def _numpy_tree():
    rng = np.random.RandomState(0)
    return {"params": {"tok": {"embed": rng.randn(8, 4).astype(np.float32)},
                       "stack": {"seg0": {"l0": {"ffn": {
                           "w_in": rng.randn(2, 4, 6).astype(np.float32)}}}}},
            "opt": {"t": np.array(7, np.int32),
                    "m": [rng.randn(3).astype(np.float32), {"a": np.arange(4, dtype=np.int32)}]},
            "bf16": rng.randn(3, 5).astype(ml_dtypes.bfloat16)}


def _to_torch(tree):
    def leaf(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, tree)


def _bytes(x):
    a = x.view(torch.uint16).numpy() if isinstance(x, torch.Tensor) and \
        x.dtype == torch.bfloat16 else np.asarray(x)
    return a.shape, a.tobytes()


def _same(got, want):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert _bytes(a) == _bytes(b), path


def test_round_trip(tmp_path):
    tree = _to_torch(_numpy_tree())
    save_checkpoint(str(tmp_path / "ck"), tree, meta={"steps": 3})
    back = load_checkpoint(str(tmp_path / "ck"), device="cpu")
    _same(back, tree)
    assert back["bf16"].dtype == torch.bfloat16 and back["opt"]["t"].dtype == torch.int32
    assert isinstance(back["opt"]["m"], list)
    assert json.loads((tmp_path / "ck.json").read_text()) == {"steps": 3}


def test_reference_file_loads_in_the_port(tmp_path):
    tree = _numpy_tree()
    jax_save(str(tmp_path / "ref.npz"), jax.tree.map(jnp.asarray, tree), meta={"k": 1})
    _same(load_checkpoint(str(tmp_path / "ref.npz"), device="cpu"), _to_torch(tree))


def test_port_file_loads_in_the_reference_with_its_bytes(tmp_path):
    tree = _numpy_tree()
    save_checkpoint(str(tmp_path / "port"), _to_torch(tree))
    jax_save(str(tmp_path / "ref"), jax.tree.map(jnp.asarray, tree))
    got, want = jax_load(str(tmp_path / "port")), jax_load(str(tmp_path / "ref"))
    _same(got, want)
    assert (tmp_path / "port.npz").read_bytes() == (tmp_path / "ref.npz").read_bytes()


def test_bf16_without_ml_dtypes_raises_naming_the_leaf(monkeypatch, tmp_path):
    import builtins
    real = builtins.__import__

    def no_ml_dtypes(name, *a, **kw):
        if name == "ml_dtypes":
            raise ImportError(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_ml_dtypes)
    with pytest.raises(ValueError, match="'stack/w'"):
        save_checkpoint(str(tmp_path / "x"), {"stack": {"w": torch.ones(2, dtype=torch.bfloat16)}})
    assert ckpt._to_numpy(torch.ones(2), "f").dtype == np.float32
