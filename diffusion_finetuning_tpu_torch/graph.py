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
weights, ``ops/conv3x3.py``, per weight) and loads every kernel, so that the
capture itself allocates none of them (both raise if asked to while a
capture runs).  A graph runs only while every tensor it reads sits where it
sat at capture: callers copy their inputs into the static buffers they
captured with, and key graphs on the identity of whatever else the graph
reads (LoRA trees, train state).  Outputs live in the shared pool, which the
next replay of any graph of the owner may overwrite: callers copy them out
right after a replay.

A failed capture or replay raises :class:`GraphError` naming the key.
Nothing runs eagerly in its place on the card.  On the CPU there are no
CUDA graphs; the callers run their functions directly there.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Optional

import torch


# graphs kept per owner, oldest dropped first: the JAX package's bound on
# its executable caches (pipelines/pipeline.py:319, training/train_step.py:116)
MAX_GRAPHS = 64


class GraphError(RuntimeError):
    """A CUDA-graph capture or replay failed; the message names its key."""


class Graph:
    """One captured graph and what its capture returned."""

    def __init__(self, key: Hashable, graph: torch.cuda.CUDAGraph, output: Any):
        self.key, self.graph, self.output = key, graph, output
        self.replays = 0

    def replay(self) -> Any:
        """Replay on the current stream; returns the capture's output
        tensors (in the pool: copy them out before the next replay)."""
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise GraphError(f"replay of CUDA graph {self.key!r} failed: {e}") from e
        self.replays += 1
        return self.output


class Graphs:
    """The CUDA graphs of one owner on ``device``: one capture stream and
    one memory pool for all of them, and a dict key -> :class:`Graph`."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        with torch.cuda.device(self.device):
            self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Hashable, Graph] = {}

    def capture(self, key: Hashable, fn: Callable[[], Any],
                warmup: Optional[Callable[[], None]] = None) -> Graph:
        """Run ``warmup`` (default: ``fn``) eagerly on the capture stream,
        then capture ``fn()`` there into a graph of the shared pool, store
        it under ``key`` (dropping the oldest graph beyond
        :data:`MAX_GRAPHS`) and return it (not yet replayed)."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            (warmup or fn)()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(self.device):
                with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                    output = fn()
        except Exception as e:
            raise GraphError(f"capture of CUDA graph {key!r} failed: {e}") from e
        finally:
            cur.wait_stream(self.stream)
        if len(self.graphs) >= MAX_GRAPHS:
            self.graphs.pop(next(iter(self.graphs)))
        entry = self.graphs[key] = Graph(key, graph, output)
        return entry

    def run(self, key: Hashable, fn: Callable[[Dict], Any], inputs: Dict,
            warmup: Optional[Callable[[Dict], None]] = None, holds: Any = None,
            replay: bool = True) -> Any:
        """``fn(static)`` through the graph of ``key``.  ``inputs``: a dict
        (nested dicts allowed) of tensors, arrays or None.  The first call of
        a key copies them into new device buffers, ``static``, and captures
        ``fn(static)`` after ``warmup(static)`` (default: ``fn``); later
        calls copy ``inputs`` into the buffers.  ``holds`` is kept with the
        graph (what it reads besides ``static``, so ids in its key stay
        unique).  Returns the replay's output -- in the pool: copy it out --
        or None with ``replay=False``."""
        entry = self.graphs.get(key)
        if entry is None:
            static = _buffers(inputs, self.device)
            entry = self.capture(key, lambda: fn(static),
                                 None if warmup is None else lambda: warmup(static))
            entry.inputs, entry.holds = static, holds
        elif replay:
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
