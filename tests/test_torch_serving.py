"""The PyTorch port's serving slice against the JAX reference, on the CPU.

Params come from the reference's init through numpy (jax.random streams
cannot be reproduced in torch). The smoke config runs in float32, as
tests/test_serving.py does, so logits agree to 1e-4 and greedy decodes
token for token; mask construction is numpy-driven and must be bitwise
equal.
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCH_IDS as jax_arch_ids  # noqa: E402
from repro.configs import all_configs as jax_all_configs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import serving as jax_serving  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, all_configs, get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.interop import masks_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serving import (ServeEngine, ServeRequest,  # noqa: E402
                                        apply_masks_to_params,
                                        mask_fingerprint,
                                        masks_from_keep_map, rate_masks)
from repro_torch.models import model as tq_model  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs():
    jcfg = dataclasses.replace(jax_get_config("stablelm-12b").smoke(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("stablelm-12b").smoke(),
                               dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _prompt(cfg, L, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, min(cfg.vocab_size, 256), (L,), dtype=np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _flat_shapes(tree, prefix=""):
    """Leaves (anything with a .shape) by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _dtypes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_dtypes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.dtype}


def test_config_schema_matches_reference():
    """Every registered config, full and smoke, equals the reference's
    field for field; the MoE and encoder-decoder ones build at smoke size
    on the CPU with the reference's param keys and shapes."""
    jcfg, tcfg = _cfgs()
    assert tcfg.reference_fields() == dataclasses.asdict(jcfg)
    assert ARCH_IDS == jax_arch_ids
    assert list(all_configs()) == list(jax_all_configs())
    for arch in ARCH_IDS:
        want, got = jax_get_config(arch), get_config(arch)
        assert got.reference_fields() == dataclasses.asdict(want), arch
        assert got.smoke().reference_fields() == dataclasses.asdict(want.smoke()), arch
        assert got.lru_dim == want.lru_dim
        assert got.layer_kinds() == want.layer_kinds(), arch
    for arch in ("deepseek-v2-lite-16b", "seamless-m4t-large-v2"):
        want = jax.eval_shape(lambda k: jax_model.init_params(jax_get_config(arch).smoke(), k),
                              jax.random.PRNGKey(0))
        want = {k: tuple(v.shape) for k, v in _flat_shapes(want).items()}
        got = _flat_shapes(tq_model.init_params(get_config(arch).smoke(), device="cpu"))
        assert {k: tuple(v.shape) for k, v in got.items()} == want, arch


ZOO = ("minicpm3-4b", "recurrentgemma-9b", "command-r-35b", "granite-20b")
# leaves init_params stores in fp32 under a bf16 dtype, though not 1-D
FP32_2D = ("bq", "bk", "bv", "bo")


def test_params_from_numpy_round_trip(setup):
    """The reference's params through numpy keep keys, shapes and values;
    with a bf16 dtype the matrices are cast and the vectors (norm scales,
    biases, MLA's q_norm/kv_norm, RG-LRU's gate vectors, a_param and
    conv_b; RG-LRU's conv_w is a matrix) keep fp32, as init_params
    stores them. StableLM's smoke params, then each of ZOO's."""
    for arch in ("stablelm-12b",) + ZOO:
        if arch == "stablelm-12b":
            jparams = setup[2]
        else:
            cfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype="float32")
            jparams = jax_model.init_params(cfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        want = _flat(jax.tree.map(np.asarray, jparams))
        got = _flat(tparams)
        assert sorted(got) == sorted(want), arch
        for k in want:
            assert got[k].shape == want[k].shape, (arch, k)
            np.testing.assert_array_equal(got[k], want[k])
        bf = _dtypes(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                       dtype=torch.bfloat16))
        for k, w in want.items():
            lead = int(k.startswith("/stack"))
            matrix = w.ndim - lead >= 2 and k.rsplit("/", 1)[1] not in FP32_2D
            assert bf[k] == (torch.bfloat16 if matrix else torch.float32), (arch, k)
        assert bf["/final_norm/scale"] == torch.float32


@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_forward_seq_and_decode_step_logits_match(setup, rate):
    jcfg, tcfg, jparams, tparams = setup
    B, S, C = 2, 6, 10
    toks = np.stack([_prompt(jcfg, S, seed=s) for s in range(B)])
    jmasks = (None if rate >= 1.0
              else jax_serving.rate_masks(jcfg, rate, policy="random", seed=3))
    tmasks = (None if jmasks is None
              else masks_from_numpy(jax.tree.map(np.asarray, jmasks)))

    jl, jc, _ = jax_model.forward_seq(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                      masks=jmasks, want_cache=True, cache_len=C)
    tl, tc, _ = tq_model.forward_seq(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                                     masks=tmasks, want_cache=True, cache_len=C)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    # decode: per-row masks (R, B, 1, f), the serving layout
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    row = lambda m: np.broadcast_to(np.asarray(m)[:, None, None, :],
                                    (m.shape[0], B, 1, m.shape[-1])).copy()
    jdm = None if jmasks is None else jax.tree.map(row, jmasks)
    tdm = None if jdm is None else masks_from_numpy(jdm)
    for step in range(2):
        jd, jc = jax_model.decode_step(jparams, jcfg, jc, jnp.asarray(nxt),
                                       jnp.asarray(pos), masks=jdm)
        td, tc = tq_model.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                      torch.from_numpy(pos), masks=tdm)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("policy", ["ordered", "random"])
def test_rate_masks_bitwise_equal(policy):
    jcfg, tcfg = _cfgs()
    for r in (1.0, 0.75, 0.5, 0.25):
        want = jax.tree.leaves(jax_serving.rate_masks(jcfg, r, policy, seed=7))
        got = tree_leaves(rate_masks(tcfg, r, policy, seed=7))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = {"l0": np.array([0, 3, 5, 100])}
    np.testing.assert_array_equal(
        tree_leaves(masks_from_keep_map(tcfg, keep))[0].numpy(),
        np.asarray(jax.tree.leaves(jax_serving.masks_from_keep_map(jcfg, keep))[0]))


def _dense_reference(cfg, params, prompt, gen_len):
    """Greedy generation by a full re-forward each step."""
    toks = list(np.asarray(prompt, np.int64))
    out = []
    for _ in range(gen_len):
        logits, _, _ = tq_model.forward_seq(
            params, cfg, {"tokens": torch.tensor([toks])})
        out.append(int(torch.argmax(logits[0, -1])))
        toks.append(out[-1])
    return np.asarray(out, np.int32)


def test_engine_matches_reference_engine_token_for_token(setup):
    """The mixed-rate, ragged queue of tests/test_serving.py through both
    engines, and through the port's own baked-mask dense reference."""
    jcfg, tcfg, jparams, tparams = setup
    kw = dict(batch_size=3, max_prompt_len=8, max_gen_len=8, chunk=4,
              bank_size=6)
    jeng = jax_serving.ServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    rates = [1.0, 0.5, 0.25, 0.75, 1.0, 0.5, 0.25]
    lens = [8, 5, 7, 3, 8, 6, 4]
    gens = [8, 3, 6, 1, 5, 8, 2]
    reqs = {}
    for i, (r, L, g) in enumerate(zip(rates, lens, gens)):
        jm = None if r >= 1.0 else jax_serving.rate_masks(jcfg, r, seed=0)
        tm = None if r >= 1.0 else rate_masks(tcfg, r, seed=0)
        prompt = _prompt(jcfg, L, seed=i)
        jrid = jeng.submit(jax_serving.ServeRequest(prompt, gen_len=g, masks=jm))
        trid = teng.submit(ServeRequest(prompt, gen_len=g, masks=tm))
        assert jrid == trid
        reqs[trid] = (prompt, g, tm)
    ops.reset_launch_counts()
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want) == sorted(reqs)
    for rid, (prompt, g, tm) in reqs.items():
        np.testing.assert_array_equal(got[rid], want[rid])
        ref_params = (tparams if tm is None
                      else apply_masks_to_params(tparams, tm, tcfg))
        np.testing.assert_array_equal(
            got[rid], _dense_reference(tcfg, ref_params, prompt, g))
    summ = teng.summary()
    assert summ["decode_tokens"] == sum(g - 1 for g in gens)
    assert summ["kernel_launches"] == {"masked_ffn_batch": 0, "decode_gqa": 0,
                                      "rwkv_chunk_scan": 0}


def test_mask_bank_dedupe_and_eviction(setup):
    _, tcfg, _, tparams = setup
    eng = ServeEngine(tcfg, tparams, batch_size=2, max_prompt_len=4,
                      max_gen_len=4, bank_size=3, device="cpu")
    m1 = rate_masks(tcfg, 0.5, seed=0)
    m1_dup = [{k: {kk: vv.clone() for kk, vv in v.items()}
               for k, v in seg.items()} for seg in m1]
    m2 = rate_masks(tcfg, 0.25, seed=0)
    m3 = rate_masks(tcfg, 0.75, seed=0)
    assert mask_fingerprint(m1) == mask_fingerprint(m1_dup)
    for m in (m1, m1_dup, m2, m3, None):
        eng.submit(ServeRequest(_prompt(tcfg, 4), gen_len=2, masks=m))
    results = eng.run()
    assert len(results) == 5
    # capacity 3 (ones + 2): m3 must have evicted a dead row, not grown K
    assert tree_leaves(eng.bank.stacked())[0].shape[0] == 3


def test_prompt_and_gen_length_validation(setup):
    _, tcfg, _, tparams = setup
    eng = ServeEngine(tcfg, tparams, batch_size=1, max_prompt_len=4,
                      max_gen_len=4, device="cpu")
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(ServeRequest(_prompt(tcfg, 6), gen_len=2))
    with pytest.raises(ValueError, match="gen_len"):
        eng.submit(ServeRequest(_prompt(tcfg, 3), gen_len=9))


def test_engine_on_cuda_raises_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, tparams = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tcfg, tparams)


def test_port_imports_no_jax_at_run_time():
    code = ("import sys, repro_torch.launch.serve, repro_torch.fl.simulation\n"
            "import repro_torch.models.moe, repro_torch.models.encdec\n"
            "import repro_torch.launch.steps, repro_torch.launch.train\n"
            "import repro_torch.optim, repro_torch.checkpoint\n"
            "import repro_torch.configs.shapes, repro_torch.launch.roofline\n"
            "import repro_torch.launch.dryrun\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path):
    """The absolute names a file imports; ``from a import b`` gives a and
    a.b, since b may be a submodule."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


_PORT = ROOT / "src" / "repro_torch"
_SUBPACKAGES = sorted(p.parent.name for p in _PORT.glob("*/__init__.py"))


@pytest.mark.parametrize("subtree,forbidden", [
    ("", ("jax", "jaxlib", "repro")),
    ("models", ("repro_torch.launch", "repro_torch.fl")),
    ("kernels", tuple(f"repro_torch.{s}" for s in _SUBPACKAGES if s != "kernels")),
], ids=["port-no-jax", "models-not-launch-fl", "kernels-self-contained"])
def test_port_sources_import_no_jax(subtree, forbidden):
    """The port imports no JAX and no reference, and its layers import
    only downward: models/ nothing of launch/ or fl/, kernels/ no other
    subpackage of the port."""
    files = sorted((_PORT / subtree).rglob("*.py"))
    if not subtree:
        files.append(ROOT / "chip_smoke.py")
    assert len(files) > 5
    for f in files:
        bad = {m for m in _imported_modules(f)
               if any(m == b or m.startswith(b + ".") for b in forbidden)}
        assert not bad, (f, bad)
