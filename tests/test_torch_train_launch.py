"""The port's training driver against the reference's, on the CPU:
``synth_batch`` bit for bit, and ``run_plain`` / ``run_fluid`` at smoke
size (StableLM-2-12B's smoke config in float32) from the reference's
initial params (the port's ``init_params`` replaced by their conversion):
losses within 1e-4, every calibration's masks identical and its unit
statistics positive (the port's optimizer updates in place, so the
previous calibration's weights are a snapshot, never an alias)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import transformer_hooks as jax_hooks  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import transformer_hooks as hooks  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as tq_model  # noqa: E402

TOL = 1e-4
OVER = dict(dtype="float32", grad_accum=1)


def _cfgs(arch="stablelm-12b"):
    return (dataclasses.replace(jax_get_config(arch).smoke(), **OVER),
            dataclasses.replace(get_config(arch).smoke(), **OVER))


def _reference_init(monkeypatch, jcfg):
    """The port's init_params gives the reference's PRNGKey(0) params."""
    jp = jax.tree.map(np.asarray, jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(tq_model, "init_params",
                        lambda cfg, seed=0, device="cuda", dtype=None:
                        params_from_numpy(jp, device))


def _record(monkeypatch, module, name, out):
    fn = getattr(module, name)

    def recorded(*a, **kw):
        res = fn(*a, **kw)
        out.append(res)
        return res
    monkeypatch.setattr(module, name, recorded)


@pytest.mark.parametrize("arch", ["stablelm-12b", "seamless-m4t-large-v2"])
def test_synth_batch_is_the_reference_bit_for_bit(arch):
    jcfg, tcfg = _cfgs(arch)
    jr, tr = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):
        jb = jax_train.synth_batch(jr, jcfg, 4, 33)
        tb = train.synth_batch(tr, tcfg, 4, 33, device="cpu")
        assert sorted(jb) == sorted(tb)
        for k in jb:
            want = np.asarray(jb[k])
            assert tb[k].dtype == {"int32": torch.int32, "float32": torch.float32}[want.dtype.name]
            assert np.array_equal(tb[k].numpy(), want), k


def test_run_plain_matches_reference(monkeypatch, tmp_path):
    jcfg, tcfg = _cfgs()
    _reference_init(monkeypatch, jcfg)
    _, jlosses = jax_train.run_plain(jcfg, 4, 2, 16, log_every=100)
    params, tlosses = train.run_plain(tcfg, 4, 2, 16, log_every=100,
                                      ckpt=str(tmp_path / "ck"), device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL, atol=TOL)
    back = load_checkpoint(str(tmp_path / "ck"), device="cpu")["params"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert torch.equal(a, b)


def test_run_fluid_matches_reference(monkeypatch):
    jcfg, tcfg = _cfgs()
    _reference_init(monkeypatch, jcfg)
    jmasks, tmasks, tstats = [], [], []
    _record(monkeypatch, jax_hooks, "build_masks", jmasks)
    _record(monkeypatch, hooks, "build_masks", tmasks)
    _record(monkeypatch, hooks, "ffn_unit_stats", tstats)
    _, jlog = jax_train.run_fluid(jcfg, 6, 2, 16, calibrate_every=3, log_every=100)
    _, tlog = train.run_fluid(tcfg, 6, 2, 16, calibrate_every=3, log_every=100,
                              device="cpu")
    np.testing.assert_allclose(np.array(tlog), np.array(jlog), rtol=TOL, atol=TOL)
    assert len(tmasks) == len(jmasks) == 2
    for tm, jm in zip(tmasks, jmasks):
        for a, b in zip(jax.tree.leaves(tm), jax.tree.leaves(jm)):
            assert np.array_equal(a.numpy(), np.asarray(b))
            kept = a.numpy().reshape(a.shape[0], -1, 128).max(-1).sum(-1)
            assert (kept == round(a.shape[-1] // 128 * 0.75)).all()
    for st in tstats:
        assert all(bool((s > 0).all()) for s in jax.tree.leaves(st))


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    for run in (train.run_plain, train.run_fluid):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(tcfg, 1, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])
