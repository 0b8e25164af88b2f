"""The port's input shapes against the JAX reference's (``configs/shapes``):
INPUT_SHAPES, window_override_for and input_specs' shapes and dtypes for
all ten archs x four shapes. The reference's decode caches carry a per-slot
position record ("slots"), which the port derives from the decode position;
every other leaf must match, key for key.
"""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shapes as jax_shapes  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, input_specs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402


def _flat(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict/list of spec leaves."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        dt = tree.dtype
        name = str(dt).replace("torch.", "") if not hasattr(dt, "name") else dt.name
        return {path: (tuple(tree.shape), name)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}/{k}"))
    return out


def test_input_shapes_match_reference():
    assert list(INPUT_SHAPES) == list(jax_shapes.INPUT_SHAPES)
    for name, s in INPUT_SHAPES.items():
        j = jax_shapes.INPUT_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.mode) == (
            j.name, j.seq_len, j.global_batch, j.mode)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in INPUT_SHAPES:
        assert shapes.window_override_for(cfg, INPUT_SHAPES[name]) == \
            jax_shapes.window_override_for(jcfg, jax_shapes.INPUT_SHAPES[name])
        got = _flat(input_specs(cfg, name))
        want = {p: (s, jnp.dtype(d).name) for p, (s, d) in
                _flat(jax_shapes.input_specs(jcfg, name)).items()
                if not p.endswith("/slots")}
        assert got == want, (arch, name)
    # batch_override cuts the batch only
    got = _flat(input_specs(cfg, "decode_32k", batch_override=2))
    assert got["/token"] == ((2, 1), "int32") and got["/pos"] == ((2,), "int32")
