"""The port's ServeEngine against the reference's on the zoo's other
decoder mixers, on the CPU: MiniCPM3-4B (MLA, baseline and absorbed
decode), RecurrentGemma-9B (RG-LRU and local attention, exact-length
prompts), Command-R-35B (parallel block), Granite-20B (MQA, biases) and
Chameleon-34B.

Smoke configs in float32, params from the reference's init through
numpy; a mixed-rate queue through both engines must give the same tokens.
RecurrentGemma's queue decodes past its 64-slot window, so the
local-attention ring wraps in both.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import serving as jax_serving  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tq_serve  # noqa: E402
from repro_torch.launch.serving import (ServeEngine, ServeRequest,  # noqa: E402
                                        apply_masks_to_params, rate_masks)
from repro_torch.models import model as tq_model  # noqa: E402

_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        jcfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype="float32")
        tcfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _SETUPS[arch] = (jcfg, tcfg, jparams, tparams)
    return _SETUPS[arch]


def _queue(arch):
    """(prompt len, gen len, rate) per request, and the engine's sizes. A
    recurrent engine takes prompts of exactly max_prompt_len; for
    RecurrentGemma prompt 60 + gen 12 reaches position 71, past the window."""
    if arch == "recurrentgemma-9b":
        kw = dict(batch_size=2, max_prompt_len=60, max_gen_len=12, chunk=4)
        reqs = [(60, 12, 1.0), (60, 5, 0.5), (60, 9, 0.25), (60, 12, 0.5)]
    else:
        kw = dict(batch_size=3, max_prompt_len=8, max_gen_len=8, chunk=4)
        reqs = [(8, 8, 1.0), (5, 3, 0.5), (7, 6, 0.25), (3, 1, 0.75),
                (8, 5, 1.0), (6, 8, 0.5)]
    return kw, reqs


@pytest.mark.parametrize("arch,absorb", [
    ("minicpm3-4b", False), ("minicpm3-4b", True), ("recurrentgemma-9b", False),
    ("command-r-35b", False), ("granite-20b", False), ("chameleon-34b", False)])
def test_engine_matches_reference_engine_token_for_token(arch, absorb):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    kw, reqs = _queue(arch)
    jeng = jax_serving.ServeEngine(jcfg, jparams, bank_size=6, mla_absorb=absorb, **kw)
    teng = ServeEngine(tcfg, tparams, bank_size=6, mla_absorb=absorb, device="cpu", **kw)
    assert teng.recurrent == jeng.recurrent == (arch == "recurrentgemma-9b")
    rng = np.random.RandomState(11)
    for L, g, r in reqs:
        prompt = rng.randint(0, 256, (L,)).astype(np.int32)
        jm = None if r >= 1.0 else jax_serving.rate_masks(jcfg, r, seed=0)
        tm = None if r >= 1.0 else rate_masks(tcfg, r, seed=0)
        assert jeng.submit(jax_serving.ServeRequest(prompt, gen_len=g, masks=jm)) == \
            teng.submit(ServeRequest(prompt, gen_len=g, masks=tm))
    ops.reset_launch_counts()
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    summ = teng.summary()
    assert summ["decode_tokens"] == sum(g - 1 for _, g, _ in reqs)
    assert set(summ["kernel_launches"].values()) == {0}       # the CPU: plain versions
    if arch == "recurrentgemma-9b":
        assert max(L + g for L, g, _ in reqs) - 1 > tcfg.window


def test_masked_engine_equals_baked_sub_model_on_a_parallel_block():
    """Command-R's parallel block: masking the FFN hidden units in the
    engine equals serving the extracted sub-model (apply_masks_to_params),
    greedy by full re-forwards."""
    _, tcfg, _, tparams = _setup("command-r-35b")
    masks = rate_masks(tcfg, 0.5, policy="random", seed=4)
    eng = ServeEngine(tcfg, tparams, batch_size=2, max_prompt_len=6,
                      max_gen_len=5, device="cpu")
    prompt = np.random.RandomState(3).randint(0, 256, (6,)).astype(np.int32)
    rid = eng.submit(ServeRequest(prompt, gen_len=5, masks=masks))
    got = eng.run()[rid]
    baked = apply_masks_to_params(tparams, masks, tcfg)
    toks, want = list(prompt.astype(np.int64)), []
    for _ in range(5):
        logits, _, _ = tq_model.forward_seq(baked, tcfg, {"tokens": torch.tensor([toks])})
        want.append(int(torch.argmax(logits[0, -1])))
        toks.append(want[-1])
    np.testing.assert_array_equal(got, want)


def test_recurrent_engine_takes_exact_length_prompts_only():
    """RG-LRU folds right padding into its state: both engines refuse a
    prompt shorter than max_prompt_len, with the same words."""
    jcfg, tcfg, jparams, tparams = _setup("recurrentgemma-9b")
    jeng = jax_serving.ServeEngine(jcfg, jparams, batch_size=1, max_prompt_len=8,
                                   max_gen_len=4)
    teng = ServeEngine(tcfg, tparams, batch_size=1, max_prompt_len=8,
                       max_gen_len=4, device="cpu")
    short = np.arange(5, dtype=np.int32)
    for eng, req in ((jeng, jax_serving.ServeRequest), (teng, ServeRequest)):
        with pytest.raises(ValueError, match="exactly 8 tokens"):
            eng.submit(req(short, gen_len=2))
        eng.submit(req(np.arange(8, dtype=np.int32), gen_len=2))
    assert len(teng.run()) == 1


@pytest.mark.parametrize("arch", ["minicpm3-4b", "recurrentgemma-9b",
                                  "command-r-35b"])
def test_serve_entry_point_runs_each_config(arch, capsys):
    """launch/serve's entry point on the smoke configs (the --full-config
    runs are chip_smoke's serve phases): every request finishes, with
    recurrent prompts of exactly --prompt-len."""
    argv = ["--arch", arch, "--device", "cpu", "--prompt-len", "8", "--gen-len", "4",
            "--rates", "1.0,0.5,0.25"]
    if arch == "minicpm3-4b":
        argv.append("--mla-absorb")
    tq_serve.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("request ") for line in out) == 4
    assert "'decode_tokens'" in out[-1]
