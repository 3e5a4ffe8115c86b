"""The serving driver (``"driver": "serve"``): ``GenerationServer`` under a
traffic file's load.

Traffic keys (``traffic/<name>.json``):

* ``arrival``: ``"open"`` (requests due on a fixed schedule: ``rate_per_s``,
  inter-arrival gaps the quantiles of the exponential distribution in the
  order ``pattern_seed`` draws) or ``"closed"`` (``clients``
  threads, each sending its next request when its last one is back);
* ``height``, ``width``, ``steps``, ``guidance``, ``scheduler`` (one the
  reference's ``SAMPLERS`` has), ``max_batch``, ``words`` ([least, most]
  words a prompt);
* ``adapters``: ``count``, ``rank``, ``up_std``, ``text_lora``,
  ``materialize`` and ``zipf_s`` (request shares of adapter k proportional
  to k^-s, as whole counts, in the order ``pattern_seed`` draws);
* ``check``: ``requests`` compared with the reference after the window,
  ``limits`` of the compared numbers, ``control`` (the precision below
  the configuration's, for ``tools/controls.py``).

A request's latency runs from when it was due to when its image is back;
one that fails or never comes counts as a miss.  The wrapper around the
server's pipe call records each dispatched batch (its size, its requests'
waits) for the per-layer metrics, and which batch each request rode in:
``images_per_s`` counts whole batches, from the first batch's completion
to the last's inside the window.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from h100_bench.harness import check as C
from h100_bench.harness import program as P
from h100_bench.harness import weights as W
from h100_bench.harness.core import percentile
from h100_bench.reference import pipeline as RP

DRAIN_S = 60.0  # how long past the window's close an answer may still come


class _PipeProxy:
    """The server's pipe with a span around each generation call."""

    def __init__(self, pipe, spans, submitted: Dict[int, float]):
        self._pipe, self._spans, self._submitted = pipe, spans, submitted
        self.batch_of: Dict[int, int] = {}  # request seed -> dispatch number

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __call__(self, **call):
        seeds = list(call["seed"])
        waits = [time.perf_counter() - self._submitted[s] for s in seeds if s in self._submitted]
        k = len(self.batch_of)
        for s in seeds:
            self.batch_of.setdefault(s, k)
        with self._spans.span("dispatch", images=len(set(seeds)), rows=len(seeds),
                              waits=waits, steps=call["num_inference_steps"],
                              height=call["height"], width=call["width"]):
            return self._pipe(**call)


def schedule(traffic: dict, seed: int, seconds: float) -> List[Dict[str, Any]]:
    """The requests of a run: due offsets (open loop) or the order clients
    take them (closed loop), prompt, seed and adapter of each.  The arrival
    gaps and the adapters' order are one realisation, drawn from the
    traffic file's ``pattern_seed``, the same in every run: the run's seed
    changes what is asked (prompts, request seeds, weights), not how much
    work arrives when, which a p90 over 120 requests would feel."""
    rng = np.random.default_rng(W.sub_seed(seed, "traffic"))
    pattern = np.random.default_rng(traffic.get("pattern_seed", 0))
    if traffic["arrival"] == "open":
        n = max(1, int(round(traffic["rate_per_s"] * seconds)))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
        gaps = pattern.permutation(gaps / gaps.sum() * seconds)
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    else:
        # closed loop: enough requests for the window at any plausible rate
        n = int(traffic.get("max_requests", 4096))
        due = np.zeros(n)  # clients send when their last answer is back
    ad = traffic["adapters"]
    k = ad["count"]
    if k:
        share = np.arange(1, k + 1, dtype=np.float64) ** -ad.get("zipf_s", 0.0)
        counts = np.floor(share / share.sum() * n).astype(int)
        counts[np.argsort(-(share / share.sum() * n - counts))[:n - counts.sum()]] += 1
        adapters = pattern.permutation(np.repeat(np.arange(k), counts))
    else:
        adapters = np.full(n, -1)
    lo, hi = traffic["words"]
    seeds = rng.choice(2 ** 31 - 1, size=n, replace=False)
    return [{"due": float(due[i]), "prompt": W.prompt(rng, int(rng.integers(lo, hi + 1))),
             "seed": int(seeds[i]),
             "adapter": None if adapters[i] < 0 else f"adapter{int(adapters[i])}"}
            for i in range(n)]


def adapter_pairs(config: dict, traffic: dict, seed: int, device) -> Dict[str, Dict[str, Any]]:
    """{adapter name: {"unet": pairs, "text": pairs or None}} in fp32."""
    ad = traffic["adapters"]
    ut = W.lora_targets("unet", config["unet"])
    tt = W.lora_targets("text_encoder", config["text_encoder"])
    out = {}
    for i in range(ad["count"]):
        out[f"adapter{i}"] = {
            "unet": W.lora_pairs(ut, seed, ("adapter", i, "unet"), ad["rank"], ad["up_std"],
                                 device),
            "text": (W.lora_pairs(tt, seed, ("adapter", i, "text"), ad["rank"], ad["up_std"],
                                  device) if ad.get("text_lora") else None)}
    return out


class Run:
    """Set-up, window and check inputs of one serving run."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.config, ctx.traffic
        RP.sampler(self.tr["scheduler"])  # the reference can follow it, or the run stops here
        self.device = ctx.device
        self.records: List[Dict[str, Any]] = []

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from diffusion_finetuning_tpu_torch.serving import GenerationServer

        ctx, tr = self.ctx, self.tr
        P.build_kernels(self.device)
        dtype = P.DTYPES[self.cfg["serve_dtype"]]
        self.pipe = P.make_pipe(self.cfg, ctx.seed, dtype, self.device)
        if not ctx.cuda_graphs:
            self.pipe.cuda_graphs = False
        self.submitted: Dict[int, float] = {}
        self.proxy = _PipeProxy(self.pipe, ctx.spans, self.submitted)
        self.server = GenerationServer(self.proxy, max_batch=tr["max_batch"])
        pairs = adapter_pairs(self.cfg, tr, ctx.seed, self.device)
        mat = tr["adapters"].get("materialize", False)
        for name, p in pairs.items():
            trees = {"unet_lora": P.lora_tree(self.pipe, "unet", p["unet"])}
            if p["text"] is not None:
                trees["text_encoder_lora"] = P.lora_tree(self.pipe, "text", p["text"])
            self.server.register_adapter(name, trees, materialize=mat)
            self.server._adapter_params(name)  # merged weights or device trees, built now
        del pairs
        self.requests = schedule(tr, ctx.seed, ctx.seconds)
        self._warm()
        self.graphs_before = self._graph_count()

    def _call(self, prompt, seed, adapter):
        tr = self.tr
        return self.server.submit(prompt, height=tr["height"], width=tr["width"],
                                  steps=tr["steps"], guidance_scale=tr["guidance"],
                                  scheduler=tr["scheduler"], seed=seed, adapter=adapter)

    def _warm(self):
        """One batch of each size on the server's ladder, for each adapter
        signature the traffic uses (every adapter here has the same one),
        through the server, before any client starts."""
        name = "adapter0" if self.tr["adapters"]["count"] else None
        for b in self.server.allowed_batches:
            futs = [self._call("a photo", 2 ** 31 + 1000 * b + i, name) for i in range(b)]
            for f in futs:
                f.result()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _graph_count(self) -> int:
        g = getattr(self.pipe, "_graphs", None)
        return 0 if g is None else len(g.graphs)

    # -- window ---------------------------------------------------------------
    def _track(self, req, fut):
        rec = {"req": req, "due": req["t_due"], "done": None, "image": None, "error": None}
        self.records.append(rec)

        def done(f):
            t = time.perf_counter()
            try:
                rec["image"] = np.asarray(f.result())
            except Exception as e:  # counted as failed
                rec["error"] = repr(e)[:300]
            rec["done"] = t
        fut.add_done_callback(done)
        return fut

    def window(self):
        ctx, tr = self.ctx, self.tr
        t0 = time.perf_counter()
        self.t_open, self.t_close = t0, t0 + ctx.seconds
        if tr["arrival"] == "open":
            late = []
            for req in self.requests:
                due = t0 + req["due"]
                now = time.perf_counter()
                if due > now:
                    with ctx.spans.span("until_due"):
                        time.sleep(due - now)
                now = time.perf_counter()
                late.append(now - due)
                req["t_due"] = due
                self.submitted[req["seed"]] = now
                with ctx.spans.span("submit"):
                    self._track(req, self._call(req["prompt"], req["seed"], req["adapter"]))
            self.lateness = late
        else:
            it = iter(self.requests)
            lock = threading.Lock()

            def client():
                while time.perf_counter() < self.t_close:
                    with lock:
                        req = next(it)
                    req["t_due"] = time.perf_counter()
                    self.submitted[req["seed"]] = req["t_due"]
                    self._track(req, self._call(req["prompt"], req["seed"],
                                                req["adapter"])).result()
            threads = [threading.Thread(target=client) for _ in range(tr["clients"])]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            self.lateness = [0.0]
        deadline = max(self.t_close, time.perf_counter()) + DRAIN_S
        while time.perf_counter() < deadline and any(r["done"] is None for r in self.records):
            time.sleep(0.01)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t_drained = time.perf_counter()

    # -- results --------------------------------------------------------------
    def end_to_end(self) -> Dict[str, Any]:
        recs = self.records
        ok = [r for r in recs if r["done"] is not None and r["error"] is None]
        out = {"attempted": len(recs), "failed": len(recs) - len(ok),
               "graphs_in_window": self._graph_count() - self.graphs_before,
               "lateness_max_s": max(self.lateness), "requests": len(recs)}
        if self.tr["arrival"] == "open":
            lat = [r["done"] - r["due"] if r in ok else math.inf for r in recs]
            p90 = percentile(lat, 90)
            out["latency_p90_s"] = p90
            out["latency_p50_s"] = percentile(lat, 50)
            out["beyond_p90"] = sum(1 for v in lat if v > p90)
        rate = batch_rate(ok, self.proxy.batch_of, self.t_open, self.t_close)
        if rate is not None:
            out["images_per_s"] = rate
        return out

    def close(self):
        """Stop the server and drop every reference to the program."""
        self.server.close()
        del self.server, self.proxy, self.pipe

    def control_inputs(self) -> Dict[str, Any]:
        """A window at the cell's own load, then the check inputs."""
        self.window()
        return self.check_inputs()

    def check_inputs(self) -> Dict[str, Any]:
        """What the reference needs of the run: the sampled requests (the
        longest-running among them), their served images, the cell's
        settings.  The program is freed after this."""
        rng = np.random.default_rng(W.sub_seed(self.ctx.seed, "check"))
        ok = [r for r in self.records if r["image"] is not None]
        pick = []
        if ok:
            longest = max(range(len(ok)), key=lambda i: ok[i]["done"] - ok[i]["due"])
            others = [i for i in range(len(ok)) if i != longest]
            k = min(self.tr["check"]["requests"] - 1, len(others))
            pick = [longest] + sorted(rng.choice(others, size=k, replace=False).tolist())
        return {"samples": [{**ok[i]["req"], "image": ok[i]["image"]} for i in pick],
                "missing": len(self.records) - len(ok)}


def batch_rate(ok: List[dict], batch_of: Dict[int, int], t_open: float,
               t_close: float) -> Optional[float]:
    """Images a second over whole batches: a batch is done when its last
    image is; the images of the batches done after the first one inside
    the window, up to the last one inside it, over the time between the
    two.  The first batch's images were made before that time began."""
    done: Dict[int, List[float]] = {}
    for r in ok:
        done.setdefault(batch_of[r["req"]["seed"]], []).append(r["done"])
    ends = sorted((max(ts), len(ts)) for ts in done.values())
    ends = [(t, n) for t, n in ends if t_open <= t <= t_close]
    if len(ends) < 2:
        return None
    return sum(n for _, n in ends[1:]) / (ends[-1][0] - ends[0][0])


def checks(ctx, inputs) -> List[tuple]:
    """The sampled requests' served images against the reference's."""
    samples = inputs["samples"]
    if not samples:
        return [("compared_requests", 0, ">= 1", False)]
    pairs = adapter_pairs(ctx.config, ctx.traffic, ctx.seed, ctx.device)
    ref = C.serve_reference(ctx.config, ctx.traffic, ctx.seed, samples, pairs, ctx.device)
    gaps = C.image_gaps([s["image"] for s in samples], ref)
    return [("compared_requests", len(samples), ">= 1", True)] + C.held(
        gaps, ctx.traffic["check"]["limits"], ("image_mean_abs_gap", "image_far_pixel_share"))


def _u8(images: List[np.ndarray]) -> List[np.ndarray]:
    return [np.round(np.clip(x, 0, 1) * 255).astype(np.uint8) for x in images]


def readings(ctx, inputs, mode: str) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(program's numbers, the control's) against the fp32 reference: the
    control is the reference computed in ``mode``, its images rounded to
    bytes as the program serves them."""
    samples = inputs["samples"]
    served = P.DTYPES[ctx.config["serve_dtype"]]
    models = C.reference_models(ctx.config, ctx.seed, served, ctx.device)
    pairs = adapter_pairs(ctx.config, ctx.traffic, ctx.seed, ctx.device)
    ref = C.serve_reference(ctx.config, ctx.traffic, ctx.seed, samples, pairs, ctx.device,
                            models=models)
    low = C.serve_reference(ctx.config, ctx.traffic, ctx.seed, samples, pairs, ctx.device,
                            mode=mode, models=models)
    return (C.image_gaps([s["image"] for s in samples], ref), C.image_gaps(_u8(low), ref))


def adapter_faults(ctx, n: int) -> Dict[str, Dict[str, float]]:
    """The reference in the program's place with the adapter fault a
    server could make: each of ``n`` of the run's requests (drawn from the
    seed) served with the next adapter's LoRA (``adapter_swapped``) or with
    none (``adapter_dropped``), its images rounded to bytes, held against
    the fp32 reference with the right adapter."""
    reqs = schedule(ctx.traffic, ctx.seed, ctx.seconds)
    rng = np.random.default_rng(W.sub_seed(ctx.seed, "faults"))
    samples = [dict(reqs[i]) for i in sorted(rng.choice(len(reqs), n, replace=False))]
    served = P.DTYPES[ctx.config["serve_dtype"]]
    models = C.reference_models(ctx.config, ctx.seed, served, ctx.device)
    pairs = adapter_pairs(ctx.config, ctx.traffic, ctx.seed, ctx.device)
    names = sorted(pairs)
    ref = C.serve_reference(ctx.config, ctx.traffic, ctx.seed, samples, pairs, ctx.device,
                            models=models)
    out = {}
    for fault, other in (("adapter_swapped", lambda a: names[(names.index(a) + 1) % len(names)]),
                         ("adapter_dropped", lambda a: None)):
        wrong = [dict(s, adapter=other(s["adapter"])) for s in samples]
        imgs = C.serve_reference(ctx.config, ctx.traffic, ctx.seed, wrong, pairs, ctx.device,
                                 models=models)
        out[fault] = C.image_gaps(_u8(imgs), ref)
    return out
