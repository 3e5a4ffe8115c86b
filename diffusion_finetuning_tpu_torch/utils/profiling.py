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
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Dict, Optional

import torch


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
