"""The program's own spans in a ``--trace 1`` run, for the per-layer readers.

The program (``diffusion_finetuning_tpu_torch.utils.profiling``) records
spans while torch's profiler is on: its server's requests and batches,
its CUDA graphs' refills, fills and replays, its trainer's dispatches and
its loader's waits, on ``time.perf_counter_ns``.  :func:`read` takes those
of the measured window, puts their clock on the device trace's and puts
each idle gap of the trace down to the innermost program span open at the
gap's middle (the server's worker thread first, where it has spans).  It
writes, into ``m["notes"]``:

* ``host_by_program_span``: for each span name, the spans begun in the
  window (``n``), their host seconds (``s``) and their seconds outside
  their children (``self_s``);
* ``request_wait_gap_max_ms``: the largest difference, over the batches,
  between the longest (and the shortest) wait from submit to the pipe's
  call as the benchmark's wrapper reads it (``dispatch`` spans' ``waits``)
  and as the server's requests read it (``queued_s + carried_s``);
* ``clock_offset_s`` and ``clock_drift_us``: the trace's clock minus
  ``perf_counter`` at the window's start, and how much more it is at its
  end, from the window's two ends on both clocks (the benchmark's
  ``window`` span, which it records on ``perf_counter`` beside its trace
  range; ``run.t_open`` and ``run.t_drained`` where it has none), the
  shift in between taken as linear;
* ``clock_residual_us`` (median) and ``clock_residual_max_us``: how far
  the ends of the benchmark's own spans, which both clocks hold, lie from
  each other after that shift (``clock_pairs`` of them; None where the
  window holds none: the closed loop's spans are all on other threads,
  whose ranges torch's profiler does not keep);
* ``idle_by_program_span``: idle seconds by the program span they fall in
  (``"no program span"`` for the rest), and
  ``idle_program_share_by_bench_span``: for each benchmark span that
  ``breakdown.idle_gaps`` names, the share of its idle time put down to a
  program span;
* ``idle_in_short_gaps_s``: idle seconds in gaps shorter than ten residuals,
  whose attribution the clocks' agreement does not settle.

:func:`read` returns None where there is nothing to read: a program
without the recorder, or one whose record dropped spans.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .core import percentile

# spans of a request's life, recorded from the times the request held: they
# cover its wait, not host work, and are never the span a gap falls in
LIFETIMES = ("server.request",)
NONE = "no program span"


class Program:
    """The window's program spans (``profiling.Span``: name, id, parent,
    thread, start and end in ns, attrs)."""

    def __init__(self, spans: list, lo_ns: float):
        self.spans = spans
        self.lo = lo_ns
        self.idle: Optional[Dict[str, float]] = None

    def named(self, name: str) -> list:
        """Spans of ``name`` that began inside the window."""
        return [s for s in self.spans if s.name == name and s.start >= self.lo]


def read(m) -> Optional[Program]:
    """The window's program spans, read once per run (kept in ``m``)."""
    if "program_spans" not in m:
        m["program_spans"] = _read(m)
    return m["program_spans"]


def _read(m) -> Optional[Program]:
    try:
        from diffusion_finetuning_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans_of = getattr(profiling, "spans", None)
    if spans_of is None:  # a program that records no spans
        return None
    notes = m.setdefault("notes", {})
    got = spans_of()
    if got is None:
        notes["program_spans_dropped"] = profiling.dropped()
        return None
    run = m["run"]
    lo, hi = run.t_open * 1e9, run.t_drained * 1e9
    prog = Program([s for s in got if s.end >= lo and s.start <= hi], lo)
    notes["host_by_program_span"] = host_by_name([s for s in prog.spans if s.start >= lo])
    gap = request_wait_gap_ms(m["spans"], prog)
    if gap is not None:
        notes["request_wait_gap_max_ms"] = gap
    trace = m.get("trace")
    if trace is None or not trace.kernels:
        return prog
    ctx = getattr(run, "ctx", None)
    window = [s for s in (ctx.spans.items if ctx is not None else ()) if s[0] == "window"]
    ends = window[-1][1:3] if window else (run.t_open, run.t_drained)
    clock, residuals = align(ends, trace, m["spans"])
    notes["clock_offset_s"] = clock.a0
    notes["clock_drift_us"] = 1e6 * (clock.a1 - clock.a0)
    notes["clock_residual_us"] = 1e6 * statistics.median(residuals) if residuals else None
    notes["clock_residual_max_us"] = 1e6 * max(residuals) if residuals else None
    notes["clock_pairs"] = len(residuals) // 2
    batches = [s.thread for s in prog.spans if s.name == "server.batch"]
    g0, g1 = gaps(trace)
    length, mid = g1 - g0, 0.5 * (g0 + g1)
    names, at = program_at(prog.spans, mid, clock, batches[0] if batches else None)
    outer, bench = _innermost([(s, e, (s,), n, False) for n, s, e in trace.host], mid,
                              "no benchmark span")
    idle = np.bincount(at, weights=length, minlength=len(names))
    prog.idle = {names[i]: float(idle[i]) for i in np.argsort(-idle) if idle[i] > 0}
    if residuals:
        short = 10 * statistics.median(residuals)
        notes["idle_in_short_gaps_s"] = float(length[length < short].sum())
    notes["idle_by_program_span"] = prog.idle
    total = np.bincount(bench, weights=length, minlength=len(outer))
    named = np.bincount(bench, weights=np.where(at != names.index(NONE), length, 0.0),
                        minlength=len(outer))
    notes["idle_program_share_by_bench_span"] = {
        outer[i]: {"idle_s": float(total[i]), "share": float(named[i] / total[i])}
        for i in range(len(outer)) if total[i] > 0}
    return prog


class Clock:
    """``perf_counter`` seconds to the trace's: ``p0`` and ``p1`` on
    ``perf_counter`` are ``p0 + a0`` and ``p1 + a1`` on the trace's clock,
    the shift linear in between (and beyond)."""

    def __init__(self, p0: float, p1: float, a0: float, a1: float):
        self.p0, self.a0, self.a1 = p0, a0, a1
        self.slope = (a1 - a0) / (p1 - p0) if p1 > p0 else 0.0

    def __call__(self, t: float) -> float:
        return t + self.a0 + self.slope * (t - self.p0)


def align(ends: Tuple[float, float], trace,
          bench: Sequence[tuple]) -> Tuple[Clock, List[float]]:
    """(clock, residuals): ``perf_counter`` put on the trace's clock by the
    window's ends, ``ends`` on ``perf_counter`` against the trace's window
    (``trace.t0``, ``trace.t1``); and, in s, how far each end of each
    benchmark span (``bench``: (name, start, end, attrs) on
    ``perf_counter``) lies from the nearest span of its name in the trace
    once moved onto its clock."""
    p0, p1 = ends
    clock = Clock(p0, p1, trace.t0 - p0, trace.t1 - p1)
    host: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for name, s, e in trace.host:
        host[name].append((s, e))
    starts = {}
    for name, lst in host.items():
        lst.sort()
        starts[name] = [s for s, _ in lst]
    res: List[float] = []
    for name, s, e, _ in bench:
        if name == "window" or name not in host:
            continue
        t = clock(s)
        i = bisect.bisect_left(starts[name], t)
        near = min((j for j in (i - 1, i) if 0 <= j < len(host[name])),
                   key=lambda j: abs(host[name][j][0] - t))
        res += [abs(host[name][near][0] - t), abs(host[name][near][1] - clock(e))]
    return clock, res


def gaps(trace) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the trace's idle gaps: ``Trace.gaps``, in arrays."""
    k = trace.kernels
    s = np.fromiter((x[1] for x in k), float, len(k))
    reach = np.maximum.accumulate(np.concatenate(([trace.t0], np.fromiter(
        (x[2] for x in k), float, len(k)))))  # the latest end before each kernel
    idle = s > reach[:-1]
    tail = [reach[-1]] if trace.t1 > reach[-1] else []
    return (np.concatenate((reach[:-1][idle], tail)),
            np.concatenate((s[idle], [trace.t1] if tail else [])))


def _innermost(ivs: Sequence[tuple], times: np.ndarray,
               none: str) -> Tuple[List[str], np.ndarray]:
    """(names, index into names at each of ``times``): of the intervals
    ``ivs`` (start, end, key, name, preferred) open at a time, the
    preferred ones if any, then the one of largest ``key``; ``none`` where
    none is open."""
    names = [none] + sorted({iv[3] for iv in ivs})
    code = {n: i for i, n in enumerate(names)}
    events = sorted([(iv[0], 0, i) for i, iv in enumerate(ivs)]
                    + [(iv[1], 1, i) for i, iv in enumerate(ivs)])
    bounds, labels, active = [], [], set()
    for j, (t, closes, i) in enumerate(events):
        (active.discard if closes else active.add)(i)
        if j + 1 < len(events) and events[j + 1][0] == t:
            continue  # every change at one time first
        pick = [ivs[a] for a in active if ivs[a][4]] or [ivs[a] for a in active]
        bounds.append(t)
        labels.append(code[max(pick, key=lambda iv: iv[2])[3]] if pick else 0)
    at = np.searchsorted(np.asarray(bounds, float), times, side="right") - 1
    return names, np.where(at >= 0, np.asarray(labels + [0], int)[at], 0)


def program_at(spans: Sequence, times: np.ndarray, clock: Clock,
               prefer_thread=None) -> Tuple[List[str], np.ndarray]:
    """(names, index into names at each of ``times``, trace clock, s): the
    innermost program span open then (the latest begun; of two begun at
    once, the later made), among those of ``prefer_thread`` first;
    :data:`NONE` where none is.  Spans of a request's life
    (:data:`LIFETIMES`) are passed over."""
    return _innermost([(clock(s.start / 1e9), clock(s.end / 1e9), (s.start, s.id), s.name,
                        s.thread == prefer_thread) for s in spans if s.name not in LIFETIMES],
                      times, NONE)


def request_wait_gap_ms(bench: Sequence[tuple], prog: Program) -> Optional[float]:
    """The largest gap (ms) between a batch's longest, or shortest, wait
    from submit to the pipe's call as the benchmark's ``dispatch`` span
    (which opens inside the batch's ``server.batch``, on ``perf_counter``
    too) reads it and as its requests' ``queued_s + carried_s`` do."""
    batches = sorted(prog.named("server.batch"), key=lambda b: b.start)
    starts = [b.start for b in batches]
    ours: Dict[int, List[float]] = defaultdict(list)
    for r in prog.named("server.request"):
        if r.attrs.get("carried_s") is not None:
            ours[r.attrs["batch"]].append(r.attrs["queued_s"] + r.attrs["carried_s"])
    worst = None
    for name, t0, _, attrs in bench:
        i = bisect.bisect_right(starts, t0 * 1e9) - 1
        if name != "dispatch" or not attrs.get("waits") or i < 0:
            continue
        mine = ours.get(batches[i].id)
        if mine and batches[i].end >= t0 * 1e9:
            w = attrs["waits"]
            gap = max(abs(max(w) - max(mine)), abs(min(w) - min(mine)))
            worst = gap if worst is None else max(worst, gap)
    return None if worst is None else 1e3 * worst


def host_by_name(spans: Sequence) -> Dict[str, Dict[str, float]]:
    """{name: {"n", "s", "self_s"}}: count, host seconds, and seconds
    outside the span's children (same thread)."""
    kids: Dict[int, int] = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            kids[s.parent] += s.end - s.start
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        o = out.setdefault(s.name, {"n": 0, "s": 0.0, "self_s": 0.0})
        o["n"] += 1
        o["s"] += (s.end - s.start) / 1e9
        o["self_s"] += (s.end - s.start - kids[s.id]) / 1e9
    return out


# -- what the readers share ------------------------------------------------------


def request_wait_p90(m, key: str) -> Optional[float]:
    """p90 of ``key`` (``queued_s``, ``carried_s``) over the window's
    dispatched requests."""
    prog = read(m)
    if prog is None:
        return None
    vals = [r.attrs[key] for r in prog.named("server.request")
            if r.attrs.get("carried_s") is not None]
    return percentile(vals, 90) if vals else None


def batch_host_ms(m) -> Optional[float]:
    """Mean host ms a batch took from its first request to its launch,
    less the coalescing wait."""
    prog = read(m)
    if prog is None:
        return None
    batches = prog.named("server.batch")
    if not batches:
        return None
    wait = defaultdict(int)
    for s in prog.spans:
        if s.name == "server.coalesce":
            wait[s.parent] += s.end - s.start
    return sum(b.end - b.start - wait[b.id] for b in batches) / len(batches) / 1e6


def refill_mb_per_batch(m) -> Optional[float]:
    prog = read(m)
    if prog is None:
        return None
    batches = prog.named("server.batch")
    if not batches:
        return None
    return sum(s.attrs["bytes"] for s in prog.named("graph.refill")) / len(batches) / 1e6


def idle_in_program_ms(m, per: str, leave_out: Tuple[str, ...] = ()) -> Optional[float]:
    """Device-idle ms put down to a program span (other than
    ``leave_out``), per ``server.batch`` (``per="batch"``) or per train
    step (``per="step"``)."""
    prog = read(m)
    if prog is None or prog.idle is None:
        return None
    idle = sum(v for k, v in prog.idle.items() if k != NONE and k not in leave_out)
    if per == "batch":
        n = len(prog.named("server.batch"))
    else:
        n = sum(s.attrs["steps"] for s in prog.named("train.dispatch"))
    return 1e3 * idle / n if n else None


def prefetch_miss_share(m) -> Optional[float]:
    """100 * the share of the window's loader waits that found the
    prefetch queue empty."""
    prog = read(m)
    if prog is None:
        return None
    waits = prog.named("data.wait")
    return 100.0 * sum(bool(w.attrs.get("miss")) for w in waits) / len(waits) if waits else None
