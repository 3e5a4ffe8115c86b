"""CUDA-graph capture and replay: the port's counterpart of ``jax.jit``.

The JAX package never runs its hot paths op by op: the pipeline jits the
whole image (``pipelines/pipeline.py:567``) and the trainers jit the step or
k fused steps (``training/train_step.py:274-612``).  Here the same code
runs eagerly once, is captured into a CUDA graph, and every later call of
the same key replays it: one launch from the host instead of thousands.

:class:`Graphs` holds the graphs of one owner (a pipeline, a train-step
function), keyed by the caller.  They share one capture stream and one
memory pool.  A capture first runs a warm-up eagerly on that stream: it
allocates what kernels allocate on first use (the split kernels' arrival
counters, ``ops/_grid.py``, are kept per stream; the fused conv's tap-major
weights, ``ops/conv3x3.py``, and the channels-last filters,
``ops/channels_last.py``, per weight) and loads every kernel, so that the
capture itself allocates none of them (each raises if asked to while a
capture runs).  A graph runs only while every tensor it reads sits where it
sat at capture: callers copy their inputs into the static buffers they
captured with, and either key graphs on the identity of whatever else the
graph reads (train state) or keep it in :class:`ParamBuffers` (the
pipeline's LoRA-dependent weights): static copies per shape signature,
shared by every graph of that signature and refilled by copy, on the
caller's stream, where their sources changed.  Outputs live in the shared
pool, which the next replay of any graph of the owner may overwrite:
callers copy them out right after a replay.

A failed capture or replay raises :class:`GraphError` naming the key.
Nothing runs eagerly in its place on the card.  On the CPU there are no
CUDA graphs; the callers run their functions directly there.

Captures and replays are counted process-wide (:data:`captures`,
:data:`replays`); the host work of each capture, parameter refill, input
fill and replay is a span (``utils/profiling.py``) while torch's profiler
is on.

Captures run in CUDA's global error mode, in which destroying a CUDA graph
(``CUDAGraph::reset``: ``cudaGraphExecDestroy``) while any capture is under
way is "not permitted when stream is capturing" and invalidates that
capture.  A graph's owner can die at any time: a train-step function and
its memoised steps form a reference cycle, which Python's cyclic collector
frees at whatever allocation triggers it, inside another owner's capture
too.  So a :class:`Graph` released while a capture is under way hands its
CUDA graph to :data:`_DEFERRED`, and the capture, once ended, destroys them.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, Hashable, Optional

import torch

from .ops import channels_last, conv3x3
from .utils import profiling


# graphs kept per owner, oldest dropped first: the JAX package's bound on
# its executable caches (pipelines/pipeline.py:319, training/train_step.py:116)
MAX_GRAPHS = 64

# captures and replays so far in this process, of every owner's graphs (the
# ops' launch counters read 0 on replays)
captures = 0
replays = 0


class GraphError(RuntimeError):
    """A CUDA-graph capture or replay failed; the message names its key."""


# captures under way in this process, and the CUDA graphs released meanwhile
# (destroyed when the count is back to 0); _STATE guards both, so no capture
# begins while a released graph is being destroyed
_STATE = threading.Lock()
_captures = 0
_DEFERRED: list = []


def _begin_capture() -> None:
    global _captures
    with _STATE:
        _captures += 1


def _end_capture() -> None:
    global _captures
    with _STATE:
        _captures -= 1
        if not _captures:
            while _DEFERRED:
                _DEFERRED.pop().reset()


class Graph:
    """One captured graph and what its capture returned."""

    def __init__(self, key: Hashable, graph: torch.cuda.CUDAGraph, output: Any):
        self.key, self.graph, self.output = key, graph, output
        self.replays = 0
        self.signature: Optional[Hashable] = None  # of the ParamBuffers it reads
        self.capture_s = 0.0  # host seconds of its warm-up and capture, both complete

    def __del__(self):
        # may run inside a capture (the cyclic collector) or on another
        # thread; a thread that holds _STATE already defers too
        graph = self.__dict__.get("graph")
        if graph is None:
            return
        if not _STATE.acquire(blocking=False):
            _DEFERRED.append(graph)
            return
        try:
            if _captures:
                _DEFERRED.append(graph)
            else:
                graph.reset()
        finally:
            _STATE.release()

    def replay(self) -> Any:
        """Replay on the current stream; returns the capture's output
        tensors (in the pool: copy them out before the next replay)."""
        global replays
        with profiling.span("graph.replay", key=self.key):
            try:
                self.graph.replay()
            except RuntimeError as e:
                raise GraphError(f"replay of CUDA graph {self.key!r} failed: {e}") from e
        self.replays += 1
        replays += 1
        return self.output


def _ident(t: torch.Tensor):
    """What identifies ``t``'s contents: the object, and its version where
    it has one (an inference tensor has none)."""
    return weakref.ref(t), (None if t.is_inference() else t._version)


class ParamBuffers:
    """Static copies of named tensors that graphs read besides their inputs
    (the pipeline's merged LoRA weights, dynamic LoRA leaves, text
    overrides): made once per shape signature, outside any graph's pool,
    and refilled by :meth:`fill`.  What each buffer holds is tracked by the
    identity (and version) of the source it was copied from, never by a
    reference to it: a source that is still the one held costs no copy,
    and nothing it belongs to is kept alive."""

    def __init__(self, sources: Dict[Hashable, torch.Tensor]):
        with torch.inference_mode(False), torch.no_grad():
            self.buffers = {k: t.detach().clone() for k, t in sources.items()}
        self.held = {k: _ident(t) for k, t in sources.items()}

    def fill(self, sources: Dict[Hashable, torch.Tensor]) -> int:
        """Copy each source that is not the one its buffer holds, on the
        current stream; returns the bytes copied.  A refilled conv weight
        has its cached copies, which a graph reads in its place, rewritten
        in place too: a 3x3 one's tap-major copy, any one's channels-last
        copy."""
        copied = 0
        with torch.inference_mode(False), torch.no_grad():
            for k, src in sources.items():
                ref, version = self.held[k]
                if ref() is src and version == (None if src.is_inference() else src._version):
                    continue
                buf = self.buffers[k]
                buf.copy_(src)
                if buf.ndim == 4:
                    channels_last.refresh(buf)
                    if tuple(buf.shape[2:]) == (3, 3):
                        conv3x3.refresh_tap_major(buf)
                self.held[k] = _ident(src)
                copied += buf.numel() * buf.element_size()
        return copied

    def forget(self) -> None:
        """Hold nothing: the next :meth:`fill` copies every source."""
        self.held = {k: (lambda: None, None) for k in self.held}


class Graphs:
    """The CUDA graphs of one owner on ``device``: one capture stream and
    one memory pool for all of them, a dict key -> :class:`Graph`, and the
    :class:`ParamBuffers` they read, by signature."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        with torch.cuda.device(self.device):
            self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Hashable, Graph] = {}
        self.params: Dict[Hashable, ParamBuffers] = {}

    def param_buffers(self, signature: Hashable,
                      sources: Dict[Hashable, torch.Tensor]) -> Dict[Hashable, torch.Tensor]:
        """The buffers of ``signature`` (the names, shapes and dtypes of
        ``sources``), made from ``sources`` at first use and filled from
        them later (:meth:`ParamBuffers.fill`)."""
        entry = self.params.get(signature)
        if entry is None:
            entry = self.params[signature] = ParamBuffers(sources)
        else:
            with profiling.span("graph.refill", key=signature) as sp:
                sp["bytes"] = entry.fill(sources)
        return entry.buffers

    def capture(self, key: Hashable, fn: Callable[[], Any],
                warmup: Optional[Callable[[], None]] = None) -> Graph:
        """Run ``warmup`` (default: ``fn``) eagerly on the capture stream,
        then capture ``fn()`` there into a graph of the shared pool, store
        it under ``key`` (dropping the oldest graph beyond
        :data:`MAX_GRAPHS`) and return it (not yet replayed)."""
        global captures
        with profiling.span("graph.capture", key=key):
            t0 = time.perf_counter()
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                (warmup or fn)()
            graph = torch.cuda.CUDAGraph()
            _begin_capture()
            try:
                with torch.cuda.device(self.device):
                    with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                        output = fn()
            except Exception as e:
                raise GraphError(f"capture of CUDA graph {key!r} failed: {e}") from e
            finally:
                _end_capture()
                cur.wait_stream(self.stream)
            if len(self.graphs) >= MAX_GRAPHS:
                self.graphs.pop(next(iter(self.graphs)))
            entry = self.graphs[key] = Graph(key, graph, output)
            entry.capture_s = time.perf_counter() - t0
            captures += 1
            return entry

    def run(self, key: Hashable, fn: Callable[[Dict], Any], inputs: Dict,
            warmup: Optional[Callable[[Dict], None]] = None, holds: Any = None,
            replay: bool = True, signature: Optional[Hashable] = None) -> Any:
        """``fn(static)`` through the graph of ``key``.  ``inputs``: a dict
        (nested dicts allowed) of tensors, arrays or None.  The first call of
        a key copies them into new device buffers, ``static``, and captures
        ``fn(static)`` after ``warmup(static)`` (default: ``fn``); later
        calls copy ``inputs`` into the buffers.  ``holds`` is kept with the
        graph (what it reads besides ``static``, so ids in its key stay
        unique); ``signature`` names the :class:`ParamBuffers` it reads,
        which are dropped with the last graph that reads them.  Returns the
        replay's output -- in the pool: copy it out -- or None with
        ``replay=False``."""
        entry = self.graphs.get(key)
        if entry is None:
            static = _buffers(inputs, self.device)
            entry = self.capture(key, lambda: fn(static),
                                 None if warmup is None else lambda: warmup(static))
            entry.inputs, entry.holds, entry.signature = static, holds, signature
            used = {g.signature for g in self.graphs.values()}
            for sig in [s for s in self.params if s not in used]:
                del self.params[sig]
        elif replay:
            with profiling.span("graph.fill_inputs", key=key):
                _fill(entry.inputs, inputs)
        return entry.replay() if replay else None


def _buffers(tree: Dict, device: torch.device) -> Dict:
    return {k: _buffers(v, device) if isinstance(v, dict) else
            None if v is None else torch.as_tensor(v).to(device, copy=True)
            for k, v in tree.items()}


def _fill(static: Dict, tree: Dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill(static[k], v)
        elif v is not None:
            static[k].copy_(torch.as_tensor(v))
