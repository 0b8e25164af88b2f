"""The dropped-dW NaN-poison contract on the CPU, and the plain FFN route
that it needs.

The masked FFN's plain versions (what a CPU or meta tensor runs) select
with the mask and never multiply by it, and leave a block a row keeps no
neuron of out of every product over F: the forward's down product and
dx's dzh·W_inᵀ / dzg·W_gateᵀ. So with every other 128-block of w_in,
w_out (and w_gate) NaN, ``masked_ffn``, ``masked_ffn_train`` and
``masked_ffn_batch`` give a finite forward and exactly-zero dropped dW, as
the reference's Pallas kernels do by skipping the tiles. On finite inputs
the selecting form equals the multiply form summed in the same block order
(``torch.equal``: a dropped entry is +0 where the product gave ±0).

``dw-zero-ffn`` runs here on the port over the reference's own case list.
The reference's ``check_dropped_dw_zero_ffn`` takes 11-19 s on this CPU,
so it is not rerun: its recorded verdict over the same cases is no
violation (``python -m repro.analysis --contract dw-zero-ffn``).
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts
from repro_torch.kernels import masked_ffn as mffn
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _one_thread():
    """These checks run many small ops: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [(F, act, gated) for F in (256, 512, 1024)
         for act, gated in (("gelu", False), ("silu", True))]


def _poisoned(F, gated, d=16, M=8, seed=0):
    nb = F // 128
    bm = np.ones(nb, np.float32)
    bm[1::2] = 0.0
    dropped = np.repeat(bm == 0, 128)
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(M, d), dtype=torch.float32)
    w = {"w_in": rng.randn(d, F).astype(np.float32),
         "w_out": rng.randn(F, d).astype(np.float32)}
    if gated:
        w["w_gate"] = rng.randn(d, F).astype(np.float32)
    for k, a in w.items():
        if k == "w_out":
            a[dropped] = np.nan
        else:
            a[:, dropped] = np.nan
    return x, {k: torch.tensor(a) for k, a in w.items()}, torch.tensor(bm), dropped


def _dropped_grads(w, dropped):
    out = {"w_in": w["w_in"].grad[:, dropped], "w_out": w["w_out"].grad[dropped]}
    if "w_gate" in w:
        out["w_gate"] = w["w_gate"].grad[:, dropped]
    return out


@pytest.mark.parametrize("F,act,gated", CASES)
def test_block_entry_poisoned_dropped_blocks(F, act, gated):
    x, w, bm, dropped = _poisoned(F, gated)
    for t in w.values():
        t.requires_grad_()
    y = ops.masked_ffn(x, w["w_in"], w["w_out"], bm, w.get("w_gate"), act=act)
    assert torch.isfinite(y).all()
    y.sum().backward()
    for k, g in _dropped_grads(w, dropped).items():
        assert (g == 0).all(), k
    assert torch.isfinite(w["w_in"].grad[:, ~dropped]).all()


@pytest.mark.parametrize("F,act,gated", CASES)
def test_train_form_poisoned_dropped_blocks(F, act, gated):
    x, w, _, dropped = _poisoned(F, gated)
    C = 2
    xs = x[None].repeat(C, 1, 1).requires_grad_()
    ws = {k: t[None].repeat(C, 1, 1).requires_grad_() for k, t in w.items()}
    rm = torch.tensor(~dropped, dtype=torch.float32).expand(C, x.shape[0], F).clone()
    rm[1, 3] = 0.0                         # a row that keeps nothing
    y = ops.masked_ffn_train(xs, ws["w_in"], ws["w_out"], rm, ws.get("w_gate"), act=act)
    assert torch.isfinite(y).all()
    assert (y[1, 3] == 0).all()
    y.sum().backward()
    assert torch.isfinite(xs.grad).all()
    g = {"w_in": ws["w_in"].grad[:, :, dropped], "w_out": ws["w_out"].grad[:, dropped]}
    if gated:
        g["w_gate"] = ws["w_gate"].grad[:, :, dropped]
    for k, t in g.items():
        assert (t == 0).all(), k


@pytest.mark.parametrize("F,act,gated", CASES)
def test_serving_form_poisoned_dropped_blocks(F, act, gated):
    x, w, _, dropped = _poisoned(F, gated)
    rng = np.random.RandomState(1)
    # per-row masks: every row keeps a random part of the kept blocks only
    rm = torch.tensor((rng.rand(x.shape[0], F) < 0.6) & ~dropped, dtype=torch.float32)
    rm[2] = 0.0
    y = ops.masked_ffn_batch(x, w["w_in"], w["w_out"], rm, w.get("w_gate"), act=act)
    assert torch.isfinite(y).all()
    assert (y[2] == 0).all()


def _multiply_forward(x, w_in, w_out, rm, w_gate, act):
    """The multiply-by-mask form, summed in the same block order."""
    ct = mffn._ct
    h = ct(x) @ ct(w_in)
    h = mffn._ACTS[act](ct(x) @ ct(w_gate)) * h if w_gate is not None else mffn._ACTS[act](h)
    h = ct((h * ct(rm)).to(x.dtype))
    y = torch.zeros(h.shape[:-1] + (w_out.shape[-1],))
    for f0 in range(0, h.shape[-1], 128):
        y = y + h[..., f0:f0 + 128] @ ct(w_out[..., f0:f0 + 128, :])
    return y.to(x.dtype)


def _multiply_dx(gy, x, w_in, w_out, rm, w_gate, act):
    ct = mffn._ct
    zh = ct(x) @ ct(w_in)
    ghm = (ct(gy) @ ct(w_out).transpose(-1, -2)) * ct(rm)
    if w_gate is not None:
        zg = ct(x) @ ct(w_gate)
        a = mffn._ACTS[act](zg)
        dzh, dzg = ghm * a, ghm * zh * mffn._DACTS[act](zg)
    else:
        dzh, dzg = ghm * mffn._DACTS[act](zh), None
    dx = torch.zeros(x.shape)
    for f0 in range(0, zh.shape[-1], 128):
        f = slice(f0, f0 + 128)
        dx = dx + dzh[..., f] @ ct(w_in[..., f]).transpose(-1, -2)
        if w_gate is not None:
            dx = dx + dzg[..., f] @ ct(w_gate[..., f]).transpose(-1, -2)
    return dx.to(x.dtype)


@pytest.mark.parametrize("F,act,gated", CASES)
def test_selecting_form_equals_multiply_form_on_finite_inputs(F, act, gated):
    rng = np.random.RandomState(F)
    C, M, d = 2, 13, 24
    r = lambda *s: torch.tensor(rng.randn(*s), dtype=torch.float32)
    x, gy, w_in, w_out = r(C, M, d), r(C, M, d), r(C, d, F), r(C, F, d)
    w_gate = r(C, d, F) if gated else None
    rm = torch.tensor(rng.rand(C, M, F) < 0.5, dtype=torch.float32)
    rm[:, :, 128:256] = 0.0                # a block no row keeps
    rm[0, 4] = 0.0                         # a row that keeps nothing
    assert torch.equal(mffn.masked_ffn_batch_plain(x, w_in, w_out, rm, w_gate, act),
                       _multiply_forward(x, w_in, w_out, rm, w_gate, act))
    assert torch.equal(mffn.masked_ffn_dx_plain(gy, x, w_in, w_out, rm, w_gate, act),
                       _multiply_dx(gy, x, w_in, w_out, rm, w_gate, act))


def test_dw_zero_ffn_clean_over_the_reference_cases():
    pytest.importorskip("jax")
    from repro.analysis import contracts as ref_contracts
    cases = ref_contracts._ffn_cases()
    assert contracts.check_dropped_dw_zero_ffn(device="cpu", cases=cases) == []


@pytest.mark.parametrize("F,kind", sorted(contracts._ffn_cases()))
def test_dw_zero_ffn_case_on_the_cpu(F, kind):
    res = contracts.ffn_poison_case(F, kind, "cpu")
    if F % 128:
        assert "multiple of BLOCK_NEURONS=128" in res["refused"]
        return
    assert res["finite"]
    assert all(res["dropped_zero"].values()), res["dropped_zero"]
    # the plain versions select, so the poisoned run is the clean run
    assert max(res["kept_err"].values()) == 0.0, res["kept_err"]
