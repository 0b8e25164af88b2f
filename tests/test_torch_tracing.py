"""The port's span recorder (``repro_torch.tracing``) and the spans the
train step and ``ServeEngine`` record, on the CPU at smoke size."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.serving import ServeEngine, ServeRequest, rate_masks
from repro_torch.models import model
from repro_torch.optim import make_optimizer


@pytest.fixture
def recording():
    tracing.drain()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_by_parent_id(recording):
    with tracing.span("outer", k=1):
        with tracing.span("inner"):
            pass
        with tracing.span("inner"):
            with tracing.span("leaf"):
                pass
    with tracing.span("second"):
        pass
    got = _by_name(tracing.drain())
    outer, second = got["outer"][0], got["second"][0]
    assert outer.parent is None and second.parent is None and outer.attrs == {"k": 1}
    assert [s.parent for s in got["inner"]] == [outer.id, outer.id]
    assert got["leaf"][0].parent == got["inner"][1].id
    for child, parent in ((got["inner"][0], outer), (got["leaf"][0], got["inner"][1])):
        assert parent.start <= child.start <= child.end <= parent.end
    assert len({s.id for v in got.values() for s in v}) == 5
    assert tracing.drain() == []


def test_request_spans_close_in_another_call(recording):
    with tracing.span("call"):
        tok = tracing.begin("req", rid=7)
    tracing.end(tok)
    got = _by_name(tracing.drain())
    req = got["req"][0]
    assert req.parent is None and req.attrs == {"rid": 7}
    assert got["call"][0].start <= req.start <= got["call"][0].end <= req.end


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    assert not tracing.enabled()
    tracing.drain()

    def no_clock():
        raise AssertionError("the clock was read with tracing off")
    monkeypatch.setattr(time, "time_ns", no_clock)
    first = tracing.span("a", rid=1)
    assert tracing.span("b") is first
    with first:
        with tracing.span("c"):
            pass
    assert tracing.begin("d", rid=2) is None
    tracing.end(None)
    assert tracing.drain() == []


def test_timed_clocks_off_and_records_on():
    with tracing.timed("t") as t:
        pass
    assert t.end >= t.start and t.seconds >= 0.0
    assert tracing.drain() == []
    tracing.enable()
    try:
        with tracing.timed("t", rid=3) as t:
            pass
    finally:
        tracing.disable()
    (s,) = tracing.drain()
    assert (s.name, s.start, s.end, s.attrs) == ("t", t.start, t.end, {"rid": 3})


def _cfg(**over):
    return dataclasses.replace(get_config("stablelm-12b").smoke(), dtype="float32", **over)


def _batch(cfg, B=2, S=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_records_its_phases_in_order(recording, accum):
    cfg = _cfg(grad_accum=accum)
    params = model.init_params(cfg, device="cpu")
    state = make_optimizer(cfg.optimizer).init(params)
    step = steps.make_train_step(cfg)
    step(params, state, _batch(cfg, B=4))
    spans = tracing.drain()
    (top,) = [s for s in spans if s.name == "train.step"]
    kids = sorted((s for s in spans if s.parent == top.id), key=lambda s: s.start)
    want = ["train.forward", "train.backward", "train.accumulate"] * accum
    if accum == 1:
        want = ["train.forward", "train.backward"]
    assert [s.name for s in kids] == want + ["train.optimizer"]
    assert len(spans) == len(kids) + 1
    assert top.start <= kids[0].start
    for a, b in zip(kids, kids[1:]):
        assert a.end <= b.start
    assert kids[-1].end <= top.end


def _engine(cfg, params, **kw):
    return ServeEngine(cfg, params, batch_size=2, max_prompt_len=8, max_gen_len=6,
                       chunk=2, bank_size=3, device="cpu", **kw)


def test_serve_engine_records_each_request_in_order(recording):
    cfg = _cfg()
    params = model.init_params(cfg, device="cpu")
    eng = _engine(cfg, params)
    rng = np.random.RandomState(0)
    rids = [eng.submit(ServeRequest(tokens=rng.randint(0, cfg.vocab_size, L), gen_len=g,
                                    masks=rate_masks(cfg, r) if r < 1 else None))
            for L, g, r in ((5, 4, 1.0), (8, 1, 0.5), (3, 6, 0.5), (6, 3, 1.0))]
    out = eng.run()
    assert sorted(out) == rids
    spans = tracing.drain()
    got = _by_name(spans)
    for rid in rids:
        one = {n: [s for s in got[n] if s.attrs.get("rid") == rid]
               for n in ("serve.request", "serve.queued", "serve.admit")}
        (req,), (queued,), (admit,) = one.values()
        assert req.start <= queued.start <= queued.end <= admit.start
        assert admit.start <= admit.end <= req.end
        kids = sorted((s for s in spans if s.parent == admit.id), key=lambda s: s.start)
        assert [s.name for s in kids][:2] == ["serve.bank_row", "serve.prefill"]
    by_id = {s.id: s for s in spans}
    for name, parent in (("serve.chunk_issue", "serve.decode_chunk"),
                         ("serve.chunk_sync", "serve.decode_chunk"),
                         ("serve.insert", "serve.admit")):
        assert got[name] and all(by_id[s.parent].name == parent for s in got[name])
    assert len(got["serve.decode_chunk"]) == len(got["serve.retire"]) == eng.stats["chunks"]


def test_serve_stats_are_the_span_sums(recording):
    cfg = _cfg()
    params = model.init_params(cfg, device="cpu")
    eng = _engine(cfg, params)
    rng = np.random.RandomState(1)
    for L, g in ((4, 5), (7, 2), (2, 6)):
        eng.submit(ServeRequest(tokens=rng.randint(0, cfg.vocab_size, L), gen_len=g))
    eng.run()
    got = _by_name(tracing.drain())
    for stat, name in (("decode_s", "serve.decode_chunk"), ("prefill_s", "serve.prefill")):
        total = 0.0
        for s in got[name]:
            total += (s.end - s.start) * 1e-9
        assert eng.stats[stat] == total > 0.0
    assert len(got["serve.prefill"]) == eng.stats["prefills"] == 3


def test_serve_engine_off_keeps_no_request_state():
    cfg = _cfg()
    eng = _engine(cfg, model.init_params(cfg, device="cpu"))
    eng.submit(ServeRequest(tokens=np.arange(1, 5), gen_len=3))
    eng.run()
    assert eng._spans == {} and tracing.drain() == []
    assert eng.stats["decode_s"] > 0.0 and eng.stats["prefill_s"] > 0.0
