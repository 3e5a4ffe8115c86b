"""Micro-batching generation server (port of the JAX package's
``serving.py``).

Concurrent txt2img requests are coalesced into device batches: callers get
a future, one worker thread drains the queue, groups requests that share
(adapter, resolution, steps, guidance, scheduler) into one batched
``pipe()`` call and fans the images back out.  The pipeline captures one
CUDA graph per (batch, resolution, steps, scheduler, LoRA signature), so
dispatched batches keep to a ladder of sizes; a partial batch is split down
the ladder rather than padded.  Per-request adapters (``register_adapter``)
generate with their own LoRA/TI trees through
``pipe.adapter_generation_params``, never with the pipe's installed ones.

The worker runs a depth-2 pipeline: it enqueues batch i+1 on the card
(``output_type="device"`` returns without a host sync, and the images'
copy to pinned host memory is enqueued right behind the batch's graph on
the same stream) before it waits for batch i's copy and resolves its
futures.  ``diffusion_finetuning_tpu_torch.serve`` exposes the server over
HTTP.  The JAX server's multi-device ``mesh`` branch is not ported.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch


@dataclass
class _Request:
    prompt: str
    negative_prompt: str
    height: int
    width: int
    steps: int
    guidance_scale: float
    scheduler: str
    seed: int
    adapter: Optional[str] = None
    future: Future = field(default_factory=Future)

    def batch_key(self) -> Tuple:
        # one batch = one LoRA tree set
        return (self.adapter, self.height, self.width, self.steps,
                self.guidance_scale, self.scheduler)

    def resolve(self, result) -> None:
        """set_result, tolerating a future the caller cancelled: it must
        not poison the rest of its batch."""
        try:
            self.future.set_result(result)
        except InvalidStateError:
            pass

    def fail(self, exc: BaseException) -> None:
        try:
            if not self.future.done():
                self.future.set_exception(exc)
        except InvalidStateError:
            pass


def _to_host(images: torch.Tensor):
    """(host tensor, event or None): on the card, a copy into pinned host
    memory enqueued on the current stream and an event recorded behind it;
    the host reads the tensor after ``event.synchronize()``."""
    if not images.is_cuda:
        return images, None
    host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
    host.copy_(images, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class GenerationServer:
    """Queue and worker thread micro-batching txt2img over one pipeline.

    ``allowed_batches`` (default the powers of two up to ``max_batch``,
    which is always on the ladder) are the batch sizes dispatched; a
    partial batch splits down the ladder, and pads by repeating its first
    request only below the smallest step.  Futures resolve to one PIL
    image each."""

    def __init__(self, pipe, max_batch: int = 8, max_wait_ms: float = 20.0,
                 allowed_batches: Optional[List[int]] = None):
        self.pipe = pipe
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        if allowed_batches is None:
            allowed_batches = [b for b in (1, 2, 4, 8) if b <= max_batch]
        self.allowed_batches = sorted(set(allowed_batches) | {max_batch})
        self._q: "queue.Queue[_Request]" = queue.Queue()
        # dequeued but not dispatched: the head of the next shape class,
        # and/or the rest of a partial batch split down the ladder
        self._carry: List[_Request] = []
        self._adapters: Dict[str, Dict[str, Any]] = {}
        self._adapter_lock = threading.Lock()
        self._stop = threading.Event()
        # submit() against close(): no request slips in after the drain
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API ----------------------------------------------------------
    def register_adapter(self, name: str, source, materialize: Optional[bool] = None,
                         **build_kwargs) -> None:
        """Register a named LoRA/TI adapter for per-request routing.
        ``source``: a ``.safetensors`` / ``.pt`` path (``build_adapter``) or
        a dict with any of ``unet_lora``, ``text_encoder_lora``,
        ``text_params``.  ``materialize`` serves this adapter merged (True)
        or dynamic (False) whatever the pipe's ``materialize_lora`` says.
        Re-registering a name swaps it for later batches."""
        if isinstance(source, str):
            from .pipelines.pipeline import build_adapter

            source = build_adapter(self.pipe, source, **build_kwargs)
        trees = dict(source)
        if materialize is not None:
            trees["materialize"] = materialize
        with self._adapter_lock:
            self._adapters[name] = trees

    def _adapter_params(self, name: Optional[str]):
        if name is None:
            return None
        with self._adapter_lock:
            trees = self._adapters[name]
        return self.pipe.adapter_generation_params(
            unet_lora=trees.get("unet_lora"), text_lora=trees.get("text_encoder_lora"),
            text_params=trees.get("text_params"), materialize=trees.get("materialize"))

    def submit(self, prompt: str, negative_prompt: str = "", height: int = 512,
               width: int = 512, steps: int = 30, guidance_scale: float = 7.5,
               scheduler: str = "dpm", seed: int = 0,
               adapter: Optional[str] = None) -> Future:
        if adapter is not None and adapter not in self._adapters:
            raise KeyError(f"unknown adapter {adapter!r}; register_adapter first")
        req = _Request(prompt, negative_prompt, height, width, steps, guidance_scale,
                       scheduler, seed, adapter)
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("GenerationServer is closed")
            self._q.put(req)
        return req.future

    def generate(self, *args, **kwargs):
        return self.submit(*args, **kwargs).result()

    def close(self):
        with self._submit_lock:
            self._stop.set()
        self._thread.join(timeout=30)
        # the worker fails its own leftovers too (it may still be in a
        # generation past the join's timeout); failing is idempotent
        self._drain_and_fail()

    def _drain_and_fail(self):
        pending = list(self._carry)
        self._carry.clear()
        while True:
            try:
                pending.append(self._q.get_nowait())
            except queue.Empty:
                break
        for r in pending:
            r.fail(RuntimeError("server closed"))

    # -- worker --------------------------------------------------------------
    def _collect(self, block: bool = True) -> List[_Request]:
        if self._carry:
            first = self._carry.pop(0)
        elif block:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                return []
        else:
            # a batch is in flight on the card: take what is queued now
            # (its generation time is the coalescing window)
            try:
                first = self._q.get_nowait()
            except queue.Empty:
                return []
        batch = [first]
        if block and len(self._carry) + self._q.qsize() < self.max_batch - 1:
            self._stop.wait(self.max_wait_s)  # the coalescing window
        while len(batch) < self.max_batch:
            if self._carry:
                # carried requests are older than anything queued
                if self._carry[0].batch_key() == first.batch_key():
                    batch.append(self._carry.pop(0))
                    continue
                break  # the head of the next shape class stays carried
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt.batch_key() == first.batch_key():
                batch.append(nxt)
            else:
                # the next batch's head, not requeued: a steady stream of
                # this shape class must not starve it
                self._carry.append(nxt)
                break
        return batch

    def _rounded(self, n: int) -> int:
        for b in self.allowed_batches:
            if b >= n:
                return b
        return self.allowed_batches[-1]

    def _resolve(self, pending) -> None:
        batch, n, (host, event) = pending
        try:
            if event is not None:
                event.synchronize()
            images = self.pipe._postprocess(host, "pil")
            for r, img in zip(batch, images[:n]):
                r.resolve(img)
        except Exception as e:
            for r in batch:
                r.fail(e)

    def _loop(self):
        pending = None
        try:
            while not self._stop.is_set():
                batch = self._collect(block=pending is None)
                out = None
                if batch:
                    r0 = batch[0]
                    n = len(batch)
                    down = max((b for b in self.allowed_batches if b <= n), default=None)
                    if down is not None and down < n:
                        # the rest goes to the front of the carry: it keeps
                        # its place before a parked next-shape head
                        self._carry[:0] = batch[down:]
                        batch = batch[:down]
                        n = down
                    nb = self._rounded(n)
                    prompts = [r.prompt for r in batch] + [r0.prompt] * (nb - n)
                    negs = [r.negative_prompt for r in batch] + [r0.negative_prompt] * (nb - n)
                    seeds = [r.seed for r in batch] + [r0.seed] * (nb - n)
                    try:
                        dev = self.pipe(
                            prompts, negative_prompt=negs, height=r0.height, width=r0.width,
                            num_inference_steps=r0.steps, guidance_scale=r0.guidance_scale,
                            scheduler=r0.scheduler, seed=seeds, output_type="device",
                            adapter_params=self._adapter_params(r0.adapter))
                        out = _to_host(dev)
                    except Exception as e:
                        for r in batch:
                            r.fail(e)
                        batch = None
                if pending is not None:
                    self._resolve(pending)
                    pending = None
                if batch and out is not None:
                    pending = (batch, len(batch), out)
        finally:
            if pending is not None:
                self._resolve(pending)
            self._drain_and_fail()
