"""The device trace of a ``--trace 1`` run: torch.profiler over the whole
measured window (and the drain of what it dispatched), read into device
kernel intervals, the benchmark's host spans on the trace's clock, the
device's busy time and its idle gaps, and the runtime's launch records,
against which :meth:`Trace.lost_records` finds device records that CUPTI
dropped.

``KERNEL_KINDS`` is a frozen copy of ``chip_smoke.py``'s classification of
device kernels by name (first match wins).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

KERNEL_KINDS = (
    ("flash_attention_fwd_packed (ours)", ("flash_fwd_bf16_packed",)),
    ("flash_attention_fwd_fp32 (ours)", ("flash_fwd_f32",)),
    ("flash_attention_fwd (ours)", ("flash_fwd",)),
    ("flash_attention_bwd_fp32 (ours)", ("flash_bwd_f32", "flash_bwd_dq_f32")),
    ("flash_attention_bwd (ours)", ("flash_bwd",)),
    ("fp32 split copies (ours)", ("split_rows", "split_cols")),
    ("lora_dense (ours)", ("lora_dense",)),
    ("conv3x3 (ours)", ("conv3x3",)),
    ("cuDNN NCHW<->NHWC transposes", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "implicit_gemm", "winograd", "fprop")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("normalisation", ("norm", "moments", "computefusedparams")),
    ("copies (contiguous, cat)", ("copy",)),
)


# runtime and driver calls that launch device work: one kernel each, or a
# CUDA graph's nodes, all under the call's correlation id
KERNEL_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")
CAPTURE = ("cudaStreamBeginCapture", "cudaStreamEndCapture")


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, subs in KERNEL_KINDS if any(s in low for s in subs)),
                "elementwise and other")


class Trace:
    """Kernels as (name, start s, end s) and host ranges ``bench.*`` as
    (name, start s, end s), on the profiler's clock."""

    def __init__(self, kernels: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], t0: float, t1: float,
                 corr: Sequence[int] = (), launches: Sequence[Tuple[str, int]] = ()):
        order = sorted(range(len(kernels)), key=lambda i: kernels[i][1])
        self.kernels = [kernels[i] for i in order]
        self.corr = [corr[i] for i in order] if corr else []
        self.launches = list(launches)  # ("kernel" | "graph", correlation id)
        self.host = host
        self.t0, self.t1 = t0, t1
        self._lost = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        busy, end = 0.0, -float("inf")
        for _, s, e in self.kernels:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def gaps(self) -> List[Tuple[float, float]]:
        out, end = [], self.t0
        for _, s, e in self.kernels:
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            out.append((end, self.t1))
        return out

    def time_by(self, match) -> Tuple[float, int]:
        """(summed seconds, count) of kernels whose name ``match`` accepts."""
        tot, n = 0.0, 0
        for name, s, e in self.kernels:
            if match(name):
                tot += e - s
                n += 1
        return tot, n

    def lost_records(self) -> Optional[Dict[str, int]]:
        """Launches whose device records the trace lacks, by the runtime's
        own launch records: a kernel launch with no device record; a graph
        launch with none; and a graph launch whose records, in an order no
        other launch shows, are a strict subsequence of those of a graph
        launched more often (the same graph with records missing; a drop
        is rare and falls at random, so two launches do not share one).
        None where the trace holds no launch record to compare with."""
        if self._lost is not None or not self.launches or not self.corr:
            return self._lost
        names: Dict[int, List[str]] = defaultdict(list)
        for (name, _, _), c in zip(self.kernels, self.corr):
            names[c].append(name)
        lost_kernels = sum(1 for kind, c in self.launches if kind == "kernel" and c not in names)
        seqs = Counter(tuple(names.get(c, ())) for kind, c in self.launches if kind == "graph")
        short = sum(n for s, n in seqs.items()
                    if not s or n == 1 and any(m > 1 and len(t) > len(s) and _subsequence(s, t)
                                               for t, m in seqs.items()))
        self._lost = {"launches": len(self.launches), "kernel_launches_lost": lost_kernels,
                      "graph_launches": sum(seqs.values()), "graph_sequences": len(seqs),
                      "graph_launches_short": short}
        return self._lost

    def breakdown(self) -> Dict[str, list]:
        by_kind: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            by_kind[kind_of(name)] += e - s
        ops = sorted(by_kind.items(), key=lambda kv: -kv[1])[:10]
        by_span: Dict[str, float] = defaultdict(float)
        for g0, g1 in self.gaps():
            by_span[self.host_at(0.5 * (g0 + g1)) or "no benchmark span"] += g1 - g0
        gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}

    def host_at(self, t: float) -> Optional[str]:
        """The innermost benchmark span the host was in at ``t``."""
        best = None
        for name, s, e in self.host:
            if s <= t <= e and (best is None or s >= best[1]):
                best = (name, s)
        return None if best is None else best[0]


def _subsequence(s: Sequence[str], t: Sequence[str]) -> bool:
    it = iter(t)
    return all(x in it for x in s)


class Profiler:
    """torch.profiler (CPU and CUDA activities) around the window."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def read(self) -> Trace:
        kernels, host, corr, calls, captures = [], [], [], [], defaultdict(list)
        res = self.prof.profiler.kineto_results
        for e in res.events():
            name = e.name()
            s = e.start_ns() / 1e9
            d = e.duration_ns() / 1e9
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if (getattr(e, "is_user_annotation", lambda: False)()
                        or name.startswith("bench.")):
                    continue
                # kernels and device copies/sets; not runtime or driver calls
                kernels.append((name, s, s + d))
                corr.append(e.correlation_id())
            elif name.startswith("bench."):
                host.append((name[len("bench."):], s, s + d))
            elif name.startswith(KERNEL_LAUNCH + GRAPH_LAUNCH):
                kind = "graph" if name.startswith(GRAPH_LAUNCH) else "kernel"
                calls.append((kind, e.correlation_id(), s, e.start_thread_id()))
            elif name.startswith(CAPTURE):
                captures[e.start_thread_id()].append((name.startswith(CAPTURE[0]), s))
        # launches made while their thread captured a graph run nothing
        spans = {th: _capture_spans(marks) for th, marks in captures.items()}
        launches = [(kind, c) for kind, c, s, th in calls
                    if not any(a <= s <= b for a, b in spans.get(th, ()))]
        win = [h for h in host if h[0] == "window"]
        if win:
            t0, t1 = win[0][1], win[0][2]
        else:
            ends = [x for k in kernels for x in k[1:]] + [x for h in host for x in h[1:]]
            t0, t1 = (min(ends), max(ends)) if ends else (0.0, 0.0)
        return Trace(kernels, host, t0, t1, corr, launches)


def _capture_spans(marks: List[Tuple[bool, float]]) -> List[Tuple[float, float]]:
    """(begin, end) of each capture from its thread's begin and end calls;
    one still open at the trace's end runs to the end."""
    out, begin = [], None
    for is_begin, t in sorted(marks, key=lambda m: m[1]):
        if is_begin:
            begin = t
        elif begin is not None:
            out.append((begin, t))
            begin = None
    if begin is not None:
        out.append((begin, float("inf")))
    return out
