"""The readers of the program's own spans (``harness/program_spans.py``):
the clock alignment and the idle-gap attribution on synthetic spans and a
synthetic trace, and tiny traced runs on the CPU that print the
program-span metrics beside the metrics the benchmark had."""

from types import SimpleNamespace

import numpy as np
import pytest

from h100_bench.harness import program_spans as PS
from h100_bench.harness.trace import Trace
from test_h100_bench_harness import _run, tiny_ctx

OFFSET = 1234.5  # the trace's clock minus perf_counter, s


def prog_span(name, start_s, end_s, sid, parent=None, thread=1, **attrs):
    """A program span as the recorder keeps it (ns on perf_counter)."""
    return SimpleNamespace(name=name, id=sid, parent=parent, thread=thread,
                           start=int(start_s * 1e9), end=int(end_s * 1e9), attrs=attrs)


def synthetic():
    """A window of 10 s on perf_counter from t = 100: a dispatch at 101-103
    holding a fill (101.0-101.5) and a replay (101.5-101.6); kernels on
    the trace's clock leave gaps at 101.2-101.3 (in the fill), 102.5-102.7
    (in the dispatch alone) and 105-106 (in no program span)."""
    t_open, t_drained = 100.0, 110.0
    spans = [prog_span("train.dispatch", 101.0, 103.0, 1, steps=1),
             prog_span("graph.fill_inputs", 101.0, 101.5, 2, parent=1),
             prog_span("graph.replay", 101.5, 101.6, 3, parent=1),
             prog_span("server.request", 100.5, 107.0, 4, queued_s=0.1, carried_s=0.2,
                       batch=None)]
    busy = [(100.0, 101.2), (101.3, 102.5), (102.7, 105.0), (106.0, 110.0)]
    kernels = [("k", a + OFFSET, b + OFFSET) for a, b in busy]
    # benchmark spans both clocks hold: 'drive' at 101-103 (a 20 us lag in
    # the trace, as record_function's own cost gives)
    host = [("window", t_open + OFFSET, t_drained + OFFSET),
            ("drive", 101.0 + OFFSET + 20e-6, 103.0 + OFFSET + 20e-6)]
    bench = [("drive", 101.0, 103.0, {})]
    trace = Trace(kernels, host, t_open + OFFSET, t_drained + OFFSET)
    return t_open, t_drained, spans, trace, bench


def test_a_known_offset_and_drift_are_recovered():
    t_open, t_drained, _, trace, bench = synthetic()
    clock, residuals = PS.align((t_open, t_drained), trace, bench)
    assert clock(105.0) == pytest.approx(105.0 + OFFSET, abs=1e-6)
    assert len(residuals) == 2 and max(residuals) == pytest.approx(20e-6, abs=1e-6)
    # the trace's clock runs 100 us fast over the window: linear in between
    fast = Trace(trace.kernels, trace.host, trace.t0, trace.t1 + 100e-6)
    clock, residuals = PS.align((t_open, t_drained), fast, [])
    assert clock(t_open) == pytest.approx(t_open + OFFSET, abs=1e-7)
    assert clock(105.0) == pytest.approx(105.0 + OFFSET + 50e-6, abs=1e-7)
    assert residuals == []


def attribute(spans, gap_list, clock, prefer_thread=None):
    names, at = PS.program_at(spans, np.asarray([0.5 * (a + b) for a, b in gap_list]), clock,
                              prefer_thread)
    return [names[i] for i in at]


def test_a_gap_goes_to_the_innermost_span_and_never_to_a_request():
    _, _, spans, trace, _ = synthetic()
    gaps = trace.gaps()
    assert [round(b - a, 6) for a, b in gaps] == [0.1, 0.2, 1.0]
    clock = PS.Clock(0.0, 1.0, OFFSET, OFFSET)
    assert attribute(spans, gaps, clock) == ["graph.fill_inputs", "train.dispatch", PS.NONE]
    # another thread's span is passed over where the preferred thread has one
    other = spans + [prog_span("data.wait", 101.1, 101.4, 5, thread=2)]
    assert attribute(other, gaps, clock)[0] == "data.wait"
    assert attribute(other, gaps, clock, prefer_thread=1)[0] == "graph.fill_inputs"


def test_vectorised_gaps_and_attribution_match_their_loops():
    """The reader's array forms against ``Trace.gaps`` and a span-by-span
    search, on random overlapping kernels and random spans on two threads."""
    rng = np.random.default_rng(7)
    starts = np.sort(rng.uniform(0, 100, 2000))
    kernels = [("k", float(a), float(a + d)) for a, d in zip(starts, rng.exponential(0.04, 2000))]
    trace = Trace(kernels, [], -1.0, 101.0)
    g0, g1 = PS.gaps(trace)
    assert np.array_equal(np.stack([g0, g1], 1), np.asarray(trace.gaps()))
    spans = []
    for i in range(300):
        a = float(rng.uniform(0, 100))
        spans.append(prog_span(f"s{i % 7}", a, a + float(rng.exponential(1.0)), i,
                               thread=int(rng.integers(1, 3))))
    clock = PS.Clock(0.0, 1.0, 0.0, 0.0)

    def loop(t, prefer):
        open_ = [x for x in spans if x.start / 1e9 <= t < x.end / 1e9]
        pick = [x for x in open_ if x.thread == prefer] or open_
        return max(pick, key=lambda x: (x.start, x.id)).name if pick else PS.NONE

    gap_list = trace.gaps()
    for prefer in (None, 2):
        want = [loop(0.5 * (a + b), prefer) for a, b in gap_list]
        assert attribute(spans, gap_list, clock, prefer) == want


def test_the_reader_writes_its_notes(monkeypatch):
    from diffusion_finetuning_tpu_torch.utils import profiling

    t_open, t_drained, spans, trace, bench = synthetic()
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    m = {"run": SimpleNamespace(t_open=t_open, t_drained=t_drained), "trace": trace,
         "spans": bench}
    assert PS.idle_in_program_ms(m, "step") == pytest.approx(300.0)
    notes = m["notes"]
    assert notes["idle_by_program_span"] == pytest.approx(
        {PS.NONE: 1.0, "train.dispatch": 0.2, "graph.fill_inputs": 0.1})
    assert notes["clock_residual_us"] == pytest.approx(20.0, abs=1.0)
    assert notes["host_by_program_span"]["train.dispatch"] == pytest.approx(
        {"n": 1, "s": 2.0, "self_s": 1.4})
    share = notes["idle_program_share_by_bench_span"]
    assert share["drive"]["share"] == pytest.approx(1.0)
    assert share["window"]["share"] == pytest.approx(0.0)
    # a record that dropped spans reads nothing
    monkeypatch.setattr(profiling, "spans", lambda: None)
    assert PS.idle_in_program_ms({"run": m["run"], "trace": trace, "spans": bench},
                                 "step") is None


def test_tiny_traced_serving_run_prints_the_program_span_metrics():
    out = _run(tiny_ctx("serve.adapters_open", trace=True, cell="sd15.serve.adapters_open"))
    assert out["correct"]
    m = out["metrics"]
    # the benchmark's own readings, as before
    assert 0 < m["batch_occupancy.serve_open"][0] <= 100
    assert m["queue_wait_p90_s.serve_open"][0] >= 0
    # the program's
    assert m["queued_wait_p90_s.serve_open"][0] >= 0
    assert m["carried_wait_p90_s.serve_open"][0] > 0
    assert m["batch_host_ms.serve_open"][0] > 0
    assert m["param_refill_mb_per_batch.serve_open"] == (0.0, "MB")  # no graphs on the CPU
    # the server's marks and the benchmark's wrapper agree on each batch's waits
    assert out["extra"]["kernel_records"]["request_wait_gap_max_ms"] < 5
    assert "idle_in_program_ms.serve_batch" not in m  # no device kernels on the CPU


def test_tiny_traced_training_run_prints_the_program_span_metrics():
    out = _run(tiny_ctx("train.dreambooth_fp32", trace=True, cell="sd15.train.dreambooth_fp32"))
    assert out["correct"]
    m = out["metrics"]
    assert m["loader_wait_ms.train"][0] >= 0 and m["mfu.train"][0] > 0
    assert 0 < m["prefetch_miss_share.train"][0] <= 100
    assert "idle_in_program_ms.train" not in m  # no device kernels on the CPU
