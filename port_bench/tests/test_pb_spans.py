"""The program's spans on the profiler's timeline: charging device
operations by their launch's correlation id, the shared clock, the six span
readers, and ``spans.py`` end to end at smoke size on the CPU."""
from types import SimpleNamespace

import pytest
import torch

from harness.attribution import READERS, SCOPED, AttributedTrace, charge, timeline
from repro_torch import tracing
from repro_torch.tracing import Span

from conftest import SERVE, TRAIN, small_cell


def test_timeline_names_the_innermost_open_span():
    spans = [("step", 0.0, 10.0), ("fwd", 0.0, 3.0), ("bwd", 4.0, 8.0), ("opt", 8.0, 9.0)]
    starts, names = timeline(spans)
    at = lambda t: names[max(i for i, s in enumerate(starts) if s <= t)]
    assert [at(t) for t in (0.0, 2.9, 3.5, 4.0, 8.0, 9.5)] == \
        ["fwd", "fwd", "step", "bwd", "opt", "step"]
    assert names[-1] is None and starts[-1] == 10.0


def test_an_op_is_charged_by_its_launch_not_its_run():
    spans = [("train.step", 0.0, 5.0), ("train.forward", 0.0, 1.0),
             ("train.backward", 1.0, 4.0), ("train.optimizer", 4.0, 5.0)]
    ops = [("fwd_kernel", 0.5, 3.5, 11),      # launched in the forward, runs past its end
           ("bwd_kernel", 3.5, 6.0, 12),      # launched in the backward, ends after every span
           ("adam", 6.0, 7.0, 13),            # launched in the optimizer
           ("feed_copy", 7.0, 7.5, 14),       # launched outside every span
           ("lost", 2.0, 2.5, 99)]            # no launch in the trace: its own start
    launches = {11: 0.2, 12: 3.9, 13: 4.5, 14: 6.5}
    got, unlinked = charge(ops, launches, spans)
    assert [g[0] for g in got] == ["train.forward", "train.backward", "train.optimizer",
                                   None, "train.backward"]
    assert unlinked == 1


def _trace(device, launches, program, bench=None):
    return AttributedTrace(device, bench or {"window": [(0.0, 10.0)]}, [], program, launches)


def _sp(name, s, e, sid, parent=None, **attrs):
    return Span(name, int(s * 1e9), int(e * 1e9), sid, parent, attrs)


def _train_run():
    program = [_sp("train.step", 1.0, 2.0, 1), _sp("train.forward", 1.0, 1.2, 2, 1),
               _sp("train.backward", 1.2, 1.8, 3, 1), _sp("train.optimizer", 1.8, 2.0, 4, 1),
               _sp("train.step", 5.0, 6.0, 5), _sp("train.forward", 5.0, 5.2, 6, 5),
               _sp("train.backward", 5.2, 5.8, 7, 5), _sp("train.optimizer", 5.8, 6.0, 8, 5)]
    device = [("f", 1.1, 2.0, 1), ("b", 2.0, 4.0, 2), ("b", 3.5, 4.5, 3), ("a", 4.5, 5.0, 4),
              ("f", 5.1, 6.0, 5), ("b", 6.0, 8.0, 6), ("a", 8.0, 8.5, 7), ("copy", 0.5, 0.6, 8)]
    launches = {1: 1.05, 2: 1.3, 3: 1.4, 4: 1.9, 5: 5.05, 6: 5.3, 7: 5.9, 8: 0.4}
    return SimpleNamespace(kind="train", trace=_trace(device, launches, program))


def test_phase_readers_take_the_union_of_what_each_phase_launched():
    run = _train_run()
    assert READERS["forward_ms.train"](run) == pytest.approx(1e3 * (0.9 + 0.9) / 2)
    assert READERS["backward_ms.train"](run) == pytest.approx(1e3 * (2.5 + 2.0) / 2)
    assert READERS["optimizer_ms.train"](run) == pytest.approx(1e3 * (0.5 + 0.5) / 2)
    by = run.trace.busy_by_span()
    assert by[None] == pytest.approx(0.1)
    assert sum(by.values()) == pytest.approx(run.trace.busy_s())
    assert READERS["decode_issue_ms"](run) is None


def _serve_run():
    program = [_sp("serve.request", 0.0, 6.0, 1, rid=0), _sp("serve.queued", 0.0, 0.0, 2, rid=0),
               _sp("serve.request", 0.0, 8.0, 3, rid=1), _sp("serve.queued", 0.0, 1.0, 4, rid=1),
               _sp("serve.admit", 0.0, 1.0, 5, rid=0), _sp("serve.prefill", 0.2, 0.9, 6, 5),
               _sp("serve.admit", 1.0, 2.0, 7, rid=1), _sp("serve.prefill", 1.1, 1.9, 8, 7),
               _sp("serve.decode_chunk", 2.0, 5.0, 9), _sp("serve.chunk_issue", 2.0, 4.0, 10, 9),
               _sp("serve.chunk_sync", 4.0, 5.0, 11, 9), _sp("serve.retire", 5.0, 5.5, 12),
               _sp("serve.decode_chunk", 6.0, 7.0, 13), _sp("serve.chunk_issue", 6.0, 6.5, 14, 13),
               _sp("serve.chunk_sync", 6.5, 7.0, 15, 13)]
    device = [("k", 2.5, 4.5, 1), ("k", 6.2, 6.6, 2), ("p", 0.3, 0.8, 3)]
    launches = {1: 2.1, 2: 6.1, 3: 0.25}
    tr = _trace(device, launches, program, {"window": [(0.0, 8.0)]})
    return SimpleNamespace(kind="serve", trace=tr, stats={"decode_steps": 4})


def test_serve_readers():
    run = _serve_run()
    assert READERS["decode_issue_ms"](run) == pytest.approx(1e3 * 2.5 / 4)
    # idle inside the chunks: 2.0-2.5 and 4.5-5.0 in the first, 6.0-6.2 and 6.6-7.0
    assert READERS["decode_idle_ms"](run) == pytest.approx(1e3 * 1.6 / 4)
    assert READERS["queue_wait_ms.serve"](run) == pytest.approx(1e3 * 0.5)
    reqs = run.trace.requests()
    assert reqs[1]["prefill"] == pytest.approx((1.1, 1.9)) and reqs[0]["queued"] == (0.0, 0.0)
    assert READERS["forward_ms.train"](run) is None


def test_request_spans_name_no_idle_gap():
    run = _serve_run()
    assert run.trace._span_at(5.7) == "between spans"      # only serve.request is open
    assert run.trace._span_at(4.7) == "serve.chunk_sync"
    assert all(not n.startswith(SCOPED) for n, _ in run.trace.idle_gaps(top=50))


def test_a_span_encloses_the_kineto_events_of_its_ops():
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(128, 128)
    tracing.drain()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracing.span("outer"):
                x @ x
            x + x
    finally:
        tracing.disable()
    (outer,) = tracing.drain()
    evs = {e.name(): e for e in prof.profiler.kineto_results.events()}
    mm, add = evs["aten::mm"], evs["aten::add"]
    assert outer.start <= mm.start_ns() <= mm.end_ns() <= outer.end
    assert add.start_ns() >= outer.end


def test_no_trace_reads_none():
    run = SimpleNamespace(kind="serve", trace=None, stats={"decode_steps": 8})
    assert all(r(run) is None for r in READERS.values())


@pytest.mark.parametrize("workload", [TRAIN, SERVE])
def test_spans_script_traced_at_smoke_size(workload):
    import spans
    w, c, t = small_cell(workload)
    line = spans.measure(w, c, t, 2 ** 31 + 7, 0.5, "traced", device="cpu")
    assert line["correct"] is True and line["mode"] == "traced"
    names = set(line["window_spans"])
    if workload == TRAIN:
        assert {"train.step", "train.forward", "train.backward", "train.optimizer"} <= names
        assert line["where"]["steps"] == line["window_spans"]["train.step"]["n"]
    else:
        assert {"serve.request", "serve.queued", "serve.admit", "serve.prefill",
                "serve.decode_chunk", "serve.chunk_issue", "serve.chunk_sync",
                "serve.retire"} <= names
        where = line["where"]
        assert where["requests"]["queued"]["n"] == line["attempted"]
        assert line["span_metrics"]["queue_wait_ms.serve"] is not None
        assert line["span_metrics"]["decode_issue_ms"] > 0
        assert where["per_step_ms"]["decode_chunk"] == pytest.approx(
            line["metrics"]["decode_step_ms"]["value"])
    assert not tracing.enabled()


@pytest.mark.parametrize("mode", ["setup", "setup_profiled"])
def test_spans_script_setup_keeps_the_first_steps(mode):
    import spans
    w, c, t = small_cell(TRAIN)
    line = spans.measure(w, c, t, 2 ** 31 + 9, 0.2, mode, device="cpu")
    n_setup = t["calibration_full_steps"] + t["checked_steps"]
    assert len(line["setup_steps"]) == n_setup
    assert set(line["setup_steps"][0]["phases_ms"]) == {"train.forward", "train.backward",
                                                        "train.optimizer"}
    assert line["setup_spans"]["train.step"]["n"] == n_setup
    assert ("first_step" in line) == (mode == "setup_profiled") and not tracing.enabled()
