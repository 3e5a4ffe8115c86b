"""Profiling and observability hooks (port of the JAX package's
``utils/profiling.py``).

The reference has no tracing, only tqdm postfixes.  This module adds a
``torch.profiler`` trace around training or inference regions (a Chrome
trace of host and device activity), a step-time tracker with rolling
statistics, and a scalar logger that fans out to tensorboard (a minimal
synchronous tfevents writer, else ``torch.utils.tensorboard``, else
``tensorboardX``, whichever is present) and/or wandb -- covering the
reference's ``accelerator.log`` and wandb usage
(train_lora_dreambooth.py:959-961, cli_lora_pti.py:390-402).  Every sink is
optional: without one, logging is a no-op.

**Spans.**  The port records spans where its host work happens, exactly
while torch's profiler is on in the process (``trace`` below, or any
``torch.profiler.profile``), from every thread; otherwise :func:`span` is
one check of the profiler's process-wide flag and returns a shared no-op.
Each span also opens a ``record_function`` range of its name, so the
Chrome trace that :func:`trace` writes shows them on the device's clock;
torch's profiler keeps only the ranges of the thread that started it
(torch 2.11, CPU and CUDA builds), so the in-memory record, :func:`spans`,
is the one that holds every thread's.  The spans:

* ``server.request`` (``serving.GenerationServer``): one per request, from
  its submit to its resolve or failure; ``queued_s`` (submit until the
  worker took it off the queue), ``carried_s`` (taken off until its batch
  was dispatched: held behind another adapter's batch, split down the
  batch ladder, or in its batch's coalescing wait), ``batch`` (the id of its ``server.batch`` span),
  ``adapter``.  Its times are the request's, recorded by the worker.
* ``server.batch``: from taking a batch's first request to the launch of
  its generation; ``images``, ``rows`` (after padding to the ladder),
  ``adapter``.  Children: ``server.coalesce`` (the worker waiting for more
  requests to join) and ``pipe.prepare`` (``StableDiffusionPipeline``:
  tokenising, the vocabulary check, latents, copies to the device;
  ``towers``, the text towers the request runs: 1, or 2 for SDXL).
* ``pipe.condition`` (``pipeline_sdxl.StableDiffusionXLPipeline``): both
  towers, the pooled projection and the context's assembly, inside a
  request's body, so on eager calls and a graph's warm-up and capture (a
  replay runs no Python); ``towers``, ``rows`` (rows encoded),
  ``zeroed_uncond`` (the unconditional half is zeros).
* ``server.resolve``: a finished batch's images to the callers, ``batch``;
  child ``server.copy_wait`` (the host waiting for the images' copy).
* ``graph.capture``, ``graph.refill`` (``ParamBuffers.fill``; ``bytes``
  copied), ``graph.fill_inputs`` (inputs copied into a graph's static
  buffers), ``graph.replay``; each with ``key``.  ``graph.captures`` and
  ``graph.replays`` count captures and replays whether or not spans are
  recorded, and so do ``ops.channels_last.calls`` (the UNet's and VAE's
  convolutions and GroupNorms that ran on channels-last activations, per
  Python call: per capture and per eager call) and
  ``ops.channels_last.fallbacks`` (those GroupNorms on the card that the
  NHWC kernel did not take, which ran PyTorch's), ``models.unet.transformer_blocks``
  (the BasicTransformerBlocks the UNet's Python calls ran: 70 an SDXL call,
  16 an SD 1.5 or 2.1 one) and ``models.clip_text.towers`` (the text-tower
  encodes: 2 an SDXL prompt encode, 1 an SD one).
* ``train.dispatch`` (``FusedDispatcher.drive``: one group's steps, then
  the next group's take and staging; ``steps``), ``train.take`` (the
  trainer's ``take_group``), ``train.stage`` (``FusedDispatcher.prepare``),
  ``train.key`` (the graph key of the train state).
* ``data.wait`` (``DataLoader``): the consumer waiting on the prefetch
  queue; ``miss`` (the queue was empty), ``epoch_start``.

Times are ``time.perf_counter_ns``.  The record is bounded
(:data:`MAX_SPANS`); :func:`spans` returns None once any span was dropped,
until :func:`clear`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch


# -- spans --------------------------------------------------------------------

MAX_SPANS = 1 << 17  # spans kept until clear(); later ones are counted, not kept

# the profiler's process-wide flag (torch.autograd._profiler_enabled() is
# per thread: it reads False on threads other than the profiler's)
_profiler = torch.autograd.profiler
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_kept: List["Span"] = []
_dropped = 0


def recording() -> bool:
    """Whether spans are recorded: while torch's profiler is on."""
    return _profiler._is_profiler_enabled


def _stack() -> List["Span"]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(s: "Span") -> None:
    global _dropped
    with _lock:
        if len(_kept) < MAX_SPANS:
            _kept.append(s)
        else:
            _dropped += 1


class Span:
    """One span: ``name``, ``id``, ``parent`` (the id of the span open
    around it on its thread, or None), ``thread`` (``threading.get_ident``),
    ``start`` and ``end`` (``time.perf_counter_ns``) and ``attrs``, which
    ``span[key] = value`` adds to inside the ``with`` block."""

    __slots__ = ("name", "id", "parent", "thread", "start", "end", "attrs", "_range")

    def __init__(self, name: str, attrs: dict, start: int = 0, end: int = 0):
        self.name, self.attrs, self.start, self.end = name, attrs, start, end
        self.id = next(_ids)
        self.parent = None
        self.thread = threading.get_ident()
        self._range = None

    def __setitem__(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        self._range.__exit__(None, None, None)
        self._range = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _keep(self)
        return False


class _Off:
    """What :func:`span` returns while nothing is recorded: a falsy no-op,
    shared, whose attributes are dropped."""

    __slots__ = ()
    id = None

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key, value) -> None:
        pass

    def __bool__(self) -> bool:
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """``with span("layer.what", key=value) as s:`` records the block while
    torch's profiler is on (``s`` is the :class:`Span`; test it before
    computing an attribute only a record needs); otherwise a shared no-op
    that reads no clock."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, attrs)


def record(name: str, start: int, end: int, **attrs) -> Optional[Span]:
    """Record a span whose times (``time.perf_counter_ns``) the caller
    held, such as a request's, which crosses threads: its attributes name
    its cause (no parent is taken from the stack).  None while nothing is
    recorded."""
    if not _profiler._is_profiler_enabled:
        return None
    s = Span(name, attrs, start, end)
    _keep(s)
    return s


def spans() -> Optional[List[Span]]:
    """The spans recorded since :func:`clear`, in the order they ended;
    None if any was dropped (more than :data:`MAX_SPANS`)."""
    with _lock:
        return None if _dropped else list(_kept)


def dropped() -> int:
    """Spans dropped since :func:`clear`."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _kept.clear()
        _dropped = 0


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU and, where there is
    one, the CUDA device) and write a Chrome trace into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Rolling step-time / throughput statistics."""

    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def steps_per_sec(self) -> float:
        m = self.mean
        return 1.0 / m if m > 0 else 0.0


class _ScalarEventWriter:
    """Minimal synchronous tfevents writer (tensorboard protos + TFRecord
    framing, no torch import, no async worker thread).

    torch's SummaryWriter wraps tensorboard's EventFileWriter, whose
    background writer thread can starve under CPU contention.  Scalar
    events are a few hundred bytes: a synchronous write needs no thread."""

    def __init__(self, log_dir: str):
        import socket

        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.summary.writer.record_writer import RecordWriter

        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(
            log_dir,
            "events.out.tfevents.%010d.%s"
            % (int(time.time()), socket.gethostname()),
        )
        self._Event = Event
        self._file = open(path, "ab")
        self._writer = RecordWriter(self._file)
        self._writer.write(
            Event(wall_time=time.time(),
                  file_version="brain.Event:2").SerializeToString())

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        ev = self._Event(wall_time=time.time(), step=int(step))
        ev.summary.value.add(tag=tag, simple_value=float(value))
        self._writer.write(ev.SerializeToString())

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.flush()
        self._file.close()


class MetricLogger:
    """Scalar logging to tensorboard and/or wandb, both optional."""

    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False):
        self._tb = None
        self._wandb = None
        if log_dir:
            writer = None
            try:
                writer = _ScalarEventWriter(log_dir)
            except Exception:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    writer = SummaryWriter(log_dir)
                except Exception:
                    try:
                        from tensorboardX import SummaryWriter

                        writer = SummaryWriter(log_dir)
                    except Exception:
                        writer = None
            self._tb = writer
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)
        if self._wandb is not None:
            if getattr(self._wandb, "run", None) is None:
                # wandb requires the caller to have called wandb.init (the
                # PTI trainer does); without an active run, log() raises —
                # disable the sink once with a warning instead
                import warnings

                warnings.warn(
                    "MetricLogger: wandb.init() was never called; disabling "
                    "the wandb sink", stacklevel=2)
                self._wandb = None
                return
            self._wandb.log(dict(metrics), step=step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
