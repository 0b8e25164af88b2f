"""The two transformer example twins, ``examples/fluid_datacenter_torch.py``
and ``examples/serve_example_torch.py``, against the reference's examples
run as they are (``runpy``) on the CPU, at the reference's own sizes: their
printed lines are compared, timing lines excepted.

The port starts from the reference's initial params (its ``init_params``
replaced by ``interop.params_from_numpy`` of the reference's
``PRNGKey(0)`` params). In float32 (the smoke config's ``dtype`` set to
float32 in both packages, as tests/test_serving.py and
tests/test_torch_serving.py compare) every printed line agrees: the
losses to their four decimals, the served tokens token for token. At the
examples' own bf16 compute the two frameworks round differently: the
losses agree to 1e-2 (4e-3 seen), and a greedy decode can take another
token at a near tie (request 1 does, at its fourth token, on the CPU
with torch 2.13), so there the requests, the first token of each (the
prefill's) and the lengths are held.
"""
import dataclasses
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import repro.configs  # noqa: E402
import repro_torch.configs  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import model as tq_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS = re.compile(r"^step +(\d+) loss (\S+) (.*)$")
TOKENS = re.compile(r"^request (\d+) -> \[(.*)\]$")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Dtype:
    """get_config(arch)'s stand-in whose smoke() computes in ``dtype``."""

    def __init__(self, cfg, dtype):
        self.cfg, self.dtype = cfg, dtype

    def smoke(self):
        return dataclasses.replace(self.cfg.smoke(), dtype=self.dtype)


def _setup(monkeypatch, dtype):
    """Both packages' smoke configs in ``dtype`` (None: as they are), and the
    port's init_params giving the reference's PRNGKey(0) params."""
    if dtype is not None:
        for mod in (repro.configs, repro_torch.configs):
            monkeypatch.setattr(mod, "get_config",
                                lambda arch, get=mod.get_config: _Dtype(get(arch), dtype))
    jp = jax.tree.map(np.asarray, jax_model.init_params(
        repro.configs.get_config("stablelm-12b").smoke(), jax.random.PRNGKey(0)))
    monkeypatch.setattr(tq_model, "init_params",
                        lambda cfg, seed=0, device="cuda", dtype=None:
                        params_from_numpy(jp, device))


def _outputs(monkeypatch, capsys, name):
    """(the reference example's printed lines, the twin's main() result and
    printed lines), both run on the CPU."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    capsys.readouterr()
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    ref = capsys.readouterr().out.splitlines()
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)              # after the patches: their get_config
    res = twin.main(["--device", "cpu"])
    return ref, res, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("dtype", ["float32", None])
def test_fluid_datacenter_twin_prints_the_reference_lines(dtype, monkeypatch, capsys):
    _setup(monkeypatch, dtype)
    ref, (full_t, fluid_t, log), got = _outputs(monkeypatch, capsys, "fluid_datacenter")
    assert len(got) == len(ref) and len(log) == 12
    assert got[-1] == ref[-1]      # the modelled full and FLuID times
    # masked from the first calibration (after step 3) on, step 3 included
    assert (full_t, fluid_t) == pytest.approx((12 * 1.3, 3 * 1.3 + 9 * 1.3 * 0.75), rel=1e-12)
    if dtype == "float32":
        assert got == ref
    for a, b in zip(ref[:-1], got[:-1]):
        ma, mb = LOSS.match(a), LOSS.match(b)
        assert (ma is None) == (mb is None), (a, b)
        if ma is None:
            assert a == b
            continue
        assert (ma[1], ma[3]) == (mb[1], mb[3])   # step, rate, full or masked
        assert abs(float(ma[2]) - float(mb[2])) <= 1e-2, (a, b)


@pytest.mark.parametrize("dtype", ["float32", None])
def test_serve_example_twin_prints_the_reference_lines(dtype, monkeypatch, capsys):
    _setup(monkeypatch, dtype)
    ref, (results, summary), got = _outputs(monkeypatch, capsys, "serve_example")
    assert len(got) == len(ref) == 11
    assert ref[-1].startswith("stablelm-12b: ") and "trace_counts=" in ref[-1]
    assert got[-1].startswith("stablelm-12b: ")
    assert "kernel_launches={'masked_ffn_batch': 0, 'decode_gqa': 0, " in got[-1]
    assert summary["kernel_launches"] == {k: 0 for k in summary["kernel_launches"]}
    assert got[:5] == ref[:5]      # the requests: rates and prompt lengths
    if dtype == "float32":
        assert got[:-1] == ref[:-1]        # every token
    for rid, (a, b) in enumerate(zip(ref[5:-1], got[5:-1])):
        ma, mb = TOKENS.match(a), TOKENS.match(b)
        ta, tb = ma[2].split(", "), mb[2].split(", ")
        assert (int(ma[1]), int(mb[1])) == (rid, rid)
        assert len(ta) == len(tb) and ta[0] == tb[0], (a, b)
        assert results[rid].tolist() == [int(t) for t in tb]
