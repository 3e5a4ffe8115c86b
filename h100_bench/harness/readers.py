"""Shared arithmetic of the per-layer metric readers (``metrics/<name>.py``).

A reader is ``read(m) -> number or None``; ``m`` holds ``spans`` (the
benchmark's host spans inside the window), ``trace`` (a ``trace.Trace``),
``run`` (the driver, with its end-to-end numbers ``e2e``), ``config`` and
``traffic``.  None means there was nothing to read: the metric is left
out of the line.
"""

from __future__ import annotations

from typing import Callable, Optional

from . import flops as F
from .core import percentile


def dispatches(m) -> list:
    return [s for s in m["spans"] if s[0] == "dispatch"]


def batch_occupancy(m) -> Optional[float]:
    d = dispatches(m)
    if not d:
        return None
    return 100.0 * sum(s[3]["images"] for s in d) / (len(d) * m["traffic"]["max_batch"])


def queue_wait_p90(m) -> Optional[float]:
    waits = [w for s in dispatches(m) for w in s[3]["waits"]]
    return percentile(waits, 90) if waits else None


def idle_share(m) -> Optional[float]:
    t = m["trace"]
    if t is None or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def served_images(m) -> int:
    return sum(s[3]["images"] for s in dispatches(m))


def serve_mfu(m) -> Optional[float]:
    t, n = m["trace"], served_images(m)
    if t is None or not n or not t.kernels:
        return None
    peak = F.PEAKS[m["config"]["serve_dtype"]]
    return 100.0 * n * F.image_flops(m["config"], m["traffic"]) / (t.window_s * peak)


def device_ms_per_image(m) -> Optional[float]:
    t, n = m["trace"], served_images(m)
    if t is None or not n or not t.kernels:
        return None
    return 1e3 * t.busy_s() / n


def train_mfu(m) -> Optional[float]:
    run = m["run"]
    if not getattr(run, "steps", 0):
        return None
    peak = F.PEAKS[m["traffic"]["dtype"]]
    el = run.t_close - run.t_open
    return 100.0 * run.steps * F.train_step_flops(m["config"], m["traffic"]) / (el * peak)


def loader_wait_ms(m) -> Optional[float]:
    waits = getattr(m["run"], "loader_waits", None)
    return 1e3 * sum(waits) / len(waits) if waits else None


def _latent(m, side_key="height") -> int:
    f = 2 ** (len(m["config"]["vae"]["block_out_channels"]) - 1)
    return m["traffic"][side_key] // f


def roofline(m, match: Callable[[str], bool], bound_s: float, calls: int):
    """100 * (bound of the ``calls`` made) / (device time of the kernels
    ``match`` accepts, however many launches a call takes); None without a
    kernel, and None where the trace lost device records (CUPTI drops
    some): the runtime's launch records disagree with the device's, or
    there are none to check against.  The time is never scaled."""
    t = m["trace"]
    if t is None:
        return None
    time_s, seen = t.time_by(match)
    if not seen or not calls:
        return None
    lost = t.lost_records()
    notes = m.setdefault("notes", {})
    notes["launch_records"] = lost
    notes[match.__name__] = {"kernels": seen, "calls": calls}
    if lost is None or lost["kernel_launches_lost"] or lost["graph_launches_short"]:
        return None
    return 100.0 * bound_s / time_s


def k2_serve_roofline(m) -> Optional[float]:
    cfg, tr = m["config"], m["traffic"]
    es = 2 if cfg["serve_dtype"] == "bfloat16" else 4
    lat = _latent(m)
    total, calls = 0.0, 0
    for s in dispatches(m):
        rows = 2 * s[3]["rows"]
        u = F.unet_lora_calls(cfg["unet"], lat, rows)
        total += s[3]["steps"] * F.sum_bounds(u, F.k2_cost, es, cfg["serve_dtype"],
                                              rank=tr["adapters"]["rank"])
        calls += s[3]["steps"] * sum(u.values())
        if tr["adapters"].get("text_lora"):
            tx = F.text_lora_calls(cfg["text_encoder"], rows)
            total += F.sum_bounds(tx, F.k2_cost, es, cfg["serve_dtype"],
                                  rank=tr["adapters"]["rank"])
            calls += sum(tx.values())

    def lora_dense(name):
        return "lora_dense" in name and "f32" not in name and "tf32" not in name
    return roofline(m, lora_dense, total, calls)


def k1_serve_roofline(m) -> Optional[float]:
    cfg = m["config"]
    es = 2 if cfg["serve_dtype"] == "bfloat16" else 4
    lat = _latent(m)
    total, calls = 0.0, 0
    for s in dispatches(m):
        a = F.attention_calls(cfg["unet"], lat, 2 * s[3]["rows"])
        total += s[3]["steps"] * F.sum_bounds(a, F.k1_cost, es, cfg["serve_dtype"])
        calls += s[3]["steps"] * sum(a.values())

    def flash_fwd(name):
        return "flash_fwd" in name and "f32" not in name and "packed" not in name
    return roofline(m, flash_fwd, total, calls)


def k3_train_roofline(m, fp32: bool) -> Optional[float]:
    cfg, tr = m["config"], m["traffic"]
    run = m["run"]
    if fp32 != (tr["dtype"] == "float32"):
        return None
    es = 4 if fp32 else 2
    a = F.attention_calls(cfg["unet"], _latent(m, "resolution"), tr["batch"])
    steps = getattr(run, "steps", 0)
    total = steps * F.sum_bounds(a, F.k3_cost, es, tr["dtype"])
    calls = steps * sum(a.values())

    def flash_bwd(name):
        return "flash_bwd" in name and (("f32" in name) == fp32)
    return roofline(m, flash_bwd, total, calls)
