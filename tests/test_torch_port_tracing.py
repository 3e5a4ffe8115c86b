"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Spans are recorded exactly while torch's profiler is on, from every thread
the port runs: the server's worker, the loader's consumer, the trainer's
dispatch.  The CUDA-graph path (``graph.py``) has no CPU form, so its test
stands torch's graph calls in with CPU fakes (a capture runs its function
once, a replay does nothing) and keeps everything above them real.
"""

import contextlib
import threading
import time
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from diffusion_finetuning_tpu_torch import graph as graph_lib
from diffusion_finetuning_tpu_torch.data.dataset import DataLoader, DreamBoothDataset
from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from diffusion_finetuning_tpu_torch.models.schedulers import SchedulerConfig
from diffusion_finetuning_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from diffusion_finetuning_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline
from diffusion_finetuning_tpu_torch.serving import GenerationServer
from diffusion_finetuning_tpu_torch.training import train_step as ts
from diffusion_finetuning_tpu_torch.training.trainer_util import DispatchLog
from diffusion_finetuning_tpu_torch.utils import profiling


@contextlib.contextmanager
def recorded():
    """torch's profiler on (CPU activity), the record emptied first."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        yield
    assert not profiling.recording()


def by_name(spans, name):
    return [s for s in spans if s.name == name]


# -- the recorder ---------------------------------------------------------------


def test_nothing_is_recorded_and_nothing_allocated_with_the_profiler_off(monkeypatch):
    profiling.clear()
    assert not profiling.recording()
    off = profiling.span("server.batch", adapter="a")
    assert off is profiling.span("data.wait") and not off and off.id is None
    assert profiling.record("server.request", 1, 2, queued_s=0.0) is None

    def no_clock():
        raise AssertionError("a span read the clock with the profiler off")

    monkeypatch.setattr(profiling.time, "perf_counter_ns", no_clock)
    for _ in range(100):  # warm whatever the interpreter caches
        with profiling.span("graph.replay", key=1) as s:
            s["bytes"] = 1
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        for _ in range(20_000):
            with profiling.span("graph.replay", key=1) as s:
                s["bytes"] = 1
        peak = tracemalloc.get_traced_memory()[1] - base
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__ and d.size_diff > 0]
    assert not grown, grown
    assert peak < 4096, f"{peak} bytes at peak over 20,000 spans"
    assert profiling.spans() == []


def test_spans_nest_per_thread_and_are_seen_from_every_thread():
    seen = {}

    def worker():
        seen["recording"] = profiling.recording()
        with profiling.span("worker.outer") as outer:
            with profiling.span("worker.inner") as inner:
                inner["k"] = 2
        seen["ids"] = (outer.id, inner.id)

    with recorded():
        with profiling.span("main.outer", x=1) as m:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            with profiling.span("main.inner"):
                pass
    assert not t.is_alive() and seen["recording"]
    spans = {s.name: s for s in profiling.spans()}
    assert set(spans) == {"main.outer", "main.inner", "worker.outer", "worker.inner"}
    assert spans["main.inner"].parent == m.id and spans["main.outer"].parent is None
    # the worker's spans are its own stack's, not the main thread's
    assert spans["worker.outer"].parent is None
    assert spans["worker.inner"].parent == seen["ids"][0]
    assert spans["worker.inner"].attrs == {"k": 2} and spans["main.outer"].attrs == {"x": 1}
    assert spans["worker.outer"].thread != spans["main.outer"].thread
    for s in spans.values():
        assert 0 < s.start <= s.end
    # after the profiler, nothing more
    with profiling.span("late"):
        pass
    assert "late" not in {s.name for s in profiling.spans()}


def test_the_record_is_bounded_and_says_when_it_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with recorded():
        for _ in range(5):
            with profiling.span("x"):
                pass
    assert profiling.dropped() == 2 and profiling.spans() is None
    profiling.clear()
    assert profiling.dropped() == 0 and profiling.spans() == []


def test_threads_recording_at_once_lose_no_span(monkeypatch):
    """More threads than cores, the interpreter switching as often as it
    can: every span is kept or counted as dropped, ids are unique, and each
    parent is the span its own thread had open."""
    import sys

    monkeypatch.setattr(profiling, "MAX_SPANS", 30_000)
    threads, each = 16, 1_000  # 2 spans an iteration: 32,000 in all
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recorded():
            def work():
                for _ in range(each):
                    with profiling.span("outer") as o:
                        with profiling.span("inner") as i:
                            assert i.parent == o.id
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    kept = profiling._kept
    assert len(kept) == 30_000 and len(kept) + profiling.dropped() == 2 * threads * each
    assert len({s.id for s in kept}) == len(kept)
    outer = {s.id: s.thread for s in kept if s.name == "outer"}
    assert all(outer.get(s.parent, s.thread) == s.thread for s in kept if s.name == "inner")


# -- the server -----------------------------------------------------------------


def tiny_pipe():
    torch.manual_seed(0)
    u, v, c = UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()
    return StableDiffusionPipeline(u, UNet2DConditionModel(u).state_dict(), v,
                                   AutoencoderKL(v).state_dict(), c,
                                   CLIPTextModel(c).state_dict(),
                                   CLIPTokenizer.tiny(["photo"]), SchedulerConfig(),
                                   device="cpu")


class _Proxy:
    """The pipe, with the time each request's seed reached its call."""

    def __init__(self, pipe):
        self._pipe, self.called = pipe, {}

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __call__(self, **call):
        t = time.perf_counter()
        for s in call["seed"]:
            self.called.setdefault(s, t)
        return self._pipe(**call)


def test_server_records_requests_and_batches_from_its_worker():
    """Two adapters interleaved: each request's span names its batch's,
    the requests behind another adapter's batch were carried, and queued
    plus carried is the time from submit to the pipe's call."""
    proxy = _Proxy(tiny_pipe())
    server = GenerationServer(proxy, max_batch=4, max_wait_ms=300)
    for name in ("a", "b"):
        server.register_adapter(name, {})
    submitted = {}
    try:
        with recorded():
            futs = []
            for seed, adapter in enumerate("abab"):
                submitted[seed] = time.perf_counter()
                futs.append(server.submit("a photo", height=16, width=16, steps=2,
                                          scheduler="ddim", seed=seed, adapter=adapter))
                if not seed:
                    time.sleep(0.05)  # the worker takes it and waits for company
            for f in futs:
                assert f.result(timeout=300).size == (16, 16)
            # the worker records a request when it resolves it
            deadline = time.time() + 30
            while len(by_name(profiling.spans(), "server.request")) < 4:
                assert time.time() < deadline
                time.sleep(0.01)
    finally:
        server.close()
    spans = profiling.spans()
    worker = server._thread.ident
    requests, batches = by_name(spans, "server.request"), by_name(spans, "server.batch")
    assert len(requests) == 4 and len(batches) >= 2
    assert {s.thread for s in requests + batches} == {worker}
    batch = {b.id: b for b in batches}
    for r in requests:
        b = batch[r.attrs["batch"]]
        assert b.attrs["adapter"] == r.attrs["adapter"] and b.attrs["rows"] >= b.attrs["images"]
        assert r.attrs["failed"] is False
    assert sum(b.attrs["images"] for b in batches) == 4
    assert max(r.attrs["carried_s"] for r in requests) > 0.05
    # the two clocks are read on two threads: a switch of the interpreter
    # lock may fall between the outside and the inside reading
    waits = sorted(proxy.called[s] - submitted[s] for s in submitted)
    inner = sorted(r.attrs["queued_s"] + r.attrs["carried_s"] for r in requests)
    assert np.allclose(inner, waits, atol=0.02), (inner, waits)
    prepares = by_name(spans, "pipe.prepare")
    assert len(prepares) == len(batches) and all(k.parent in batch for k in prepares)
    assert all(k.parent in batch for k in by_name(spans, "server.coalesce"))
    resolves = by_name(spans, "server.resolve")
    assert {r.attrs["batch"] for r in resolves} == set(batch)


# -- the loader -----------------------------------------------------------------


class _Slow:
    """A dataset whose items take 0.2 s each to make."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        time.sleep(0.2)
        return self.ds[i]


def test_loader_misses_at_each_epoch_start(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.png")
    tok = CLIPTokenizer.tiny(["photo"])
    ds = DreamBoothDataset(str(tmp_path), "a photo", tok, size=16, seed=0)
    loader = DataLoader(_Slow(ds), 1, tok.encoder[tok.pad_token], seed=0)
    with recorded():
        for _ in range(2):
            for batch in loader:
                assert batch["pixel_values"].shape[0] == 1
                time.sleep(1.0)  # a step: the prefetch fills meanwhile
    waits = by_name(profiling.spans(), "data.wait")
    got = [(w.attrs["epoch_start"], w.attrs["miss"]) for w in waits]
    # three batches and the end marker an epoch
    assert got == [(True, True)] + [(False, False)] * 3 + [(True, True)] + [(False, False)] * 3


# -- the trainer's dispatch and graph.py, on CPU stand-ins for CUDA graphs ---------


class _Stream:
    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


class _CUDAGraph:
    def replay(self):
        pass

    def reset(self):
        pass


@pytest.fixture
def cpu_graphs(monkeypatch):
    """torch.cuda's graph calls as CPU stand-ins."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _CUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **k: contextlib.nullcontext())


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: the train step takes its
    graph path."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _toy_step(state, batch, generator=None, draws=None):
    w = state["params"]["unet_lora"]["w"]
    with torch.no_grad():
        w.add_(torch.as_tensor(batch["x"]).float().mean() + draws["d"])
    return state, {"loss": w.sum()}


def test_drive_nests_take_key_and_graphs_under_dispatch(cpu_graphs, monkeypatch):
    cpu = graph_lib.Graphs(torch.device("cpu"))
    monkeypatch.setattr(ts, "_graphs", lambda fn, device: cpu)
    state = {"params": {"unet_lora": {"w": torch.zeros(3)}, "text_lora": None,
                        "ti_embeddings": None},
             "static": {}, "opt_state": SimpleNamespace(tensors=lambda: []), "step": 0,
             "device_step": torch.zeros((), dtype=torch.int64).as_subclass(_OnCard)}
    dispatcher = ts.FusedDispatcher(_toy_step, spd=1)

    def take(gs):
        return [{"x": np.full((2,), gs, np.float32)}]

    n = 4
    captures, replays = graph_lib.captures, graph_lib.replays
    log = DispatchLog("toy", torch.device("cpu"))
    with recorded():
        for _, losses, stepped, gs in dispatcher.drive(
                state, None, take, n, draws=lambda s: {"d": torch.tensor(float(s))}):
            log.tick(losses, stepped)
            log.resume()
    summary = log.summary()
    assert (graph_lib.captures - captures, graph_lib.replays - replays) == (1, n)
    assert (summary["graph_captures"], summary["graph_replays"]) == (1, n)
    assert summary["steps"] == n
    spans = profiling.spans()
    dispatch = {s.id: s for s in by_name(spans, "train.dispatch")}
    assert len(dispatch) == n and all(s.attrs["steps"] == 1 for s in dispatch.values())
    for name, count in (("train.key", n), ("graph.capture", 1), ("graph.replay", n),
                        ("graph.fill_inputs", n - 1), ("train.take", n - 1),
                        ("train.stage", n - 1)):
        inside = [s for s in by_name(spans, name) if s.parent in dispatch]
        assert len(inside) == count, (name, len(inside))
    # the first group is taken before the first dispatch
    assert len(by_name(spans, "train.take")) == n


def test_param_refill_span_counts_the_bytes_copied(cpu_graphs):
    graphs = graph_lib.Graphs(torch.device("cpu"))
    a, b = torch.randn(4, 3), torch.randn(5)
    with recorded():
        graphs.param_buffers("sig", {"a": a, "b": b})  # made, not refilled
        graphs.param_buffers("sig", {"a": a, "b": b})  # held: nothing copied
        graphs.param_buffers("sig", {"a": torch.randn(4, 3), "b": b})
    refills = by_name(profiling.spans(), "graph.refill")
    assert [(r.attrs["key"], r.attrs["bytes"]) for r in refills] == [("sig", 0), ("sig", 48)]
