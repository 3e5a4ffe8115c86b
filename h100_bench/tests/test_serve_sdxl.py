"""The SDXL driver (``drivers/serve_sdxl.py``) and its counts
(``harness/sdxl_flops.py``) on the CPU: a tiny run is correct, runs with the
program broken underneath are not, a program without the SDXL pipe stops at
once, and the operation counts agree with hand counts at SDXL's published
shapes."""

import json
import time
import types

import pytest
import torch

from conftest import ROOT
from h100_bench.harness import core, runner
from h100_bench.harness import sdxl_flops as X

drv = core.load_driver(ROOT / "h100_bench" / "drivers" / "serve_sdxl.py")
TINY = ROOT / "h100_bench" / "tests" / "tiny"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FULL = json.loads((ROOT / "h100_bench" / "configs" / "sdxl_base.json").read_text())
CELL = "sdxl_base.serve.batch_lora"
E2E = [{"name": "setup_s", "unit": "s"}, {"name": "images_per_s", "unit": "images/s"}]


def tiny_ctx(trace=False, seed=20_000_000_013):
    cfg = json.loads((TINY / "tiny_sdxl.json").read_text())
    tr = json.loads((TINY / "serve.batch_lora_sdxl.json").read_text())
    spec = core.resolve(BENCH, CELL) if trace else {"per_layer": [], "readers": {}}
    return runner.Ctx(workload=CELL if trace else "tiny", seed=seed, seconds=2.0, trace=trace,
                      device=torch.device("cpu"), config=cfg, traffic=tr, end_to_end=E2E,
                      per_layer=spec["per_layer"], readers=spec["readers"])


def _run(ctx):
    return runner.run_cell(ctx, time.perf_counter())


def test_tiny_run_is_correct():
    out = _run(tiny_ctx())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]


def test_tiny_traced_run_reads_the_program_spans():
    out = _run(tiny_ctx(trace=True))
    assert out["correct"]
    m = out["metrics"]
    assert m["prepare_ms_per_batch.serve_sdxl"][0] > 0
    assert "idle_share.serve_batch" not in m  # no device kernels on the CPU


@pytest.mark.parametrize("fault", ["image", "tower_2_lora", "uncond"])
def test_a_broken_program_is_not_correct(monkeypatch, fault):
    """The served image altered; tower 2's LoRA left out; the unconditional
    half encoded from the empty prompt in place of the published zeros."""
    from diffusion_finetuning_tpu_torch.pipelines.pipeline_sdxl import StableDiffusionXLPipeline

    if fault == "image":
        real = StableDiffusionXLPipeline._decode
        monkeypatch.setattr(StableDiffusionXLPipeline, "_decode",
                            lambda self, x: 255 - real(self, x))
    elif fault == "tower_2_lora":
        real = StableDiffusionXLPipeline.adapter_generation_params
        monkeypatch.setattr(StableDiffusionXLPipeline, "adapter_generation_params",
                            lambda self, *a, text_lora_2=None, **k: real(self, *a, **k))
    else:
        real = StableDiffusionXLPipeline._text_inputs
        monkeypatch.setattr(StableDiffusionXLPipeline, "_text_inputs",
                            lambda self, negs, *a: real(self, [" "] * len(negs), *a))
    ctx = tiny_ctx()
    ctx.traffic["adapters"]["up_std"] = 0.3  # the adapter moves the tiny images visibly
    ctx.traffic["check"]["limits"]["image_mean_abs_gap"] = 0.005
    out = _run(ctx)
    assert not out["correct"], out["checks"]


def test_a_program_without_sdxl_stops_before_set_up(monkeypatch):
    monkeypatch.setattr(drv, "ENTRY", "diffusion_finetuning_tpu_torch.pipelines.no_such_pipe")
    with pytest.raises(SystemExit) as e:
        drv.Run(tiny_ctx())
    assert e.value.code == 2


def test_the_control_reads_above_the_program():
    from h100_bench.tools import controls

    ctx = tiny_ctx()
    prog, ctrl = controls.readings(ctx, ctx.traffic["check"]["control"])
    assert ctrl["image_mean_abs_gap"] > 3 * prog["image_mean_abs_gap"], (prog, ctrl)


def test_adapter_faults_read_at_a_tiny_size():
    out = drv.adapter_faults(tiny_ctx(), 2)
    assert set(out) == {"adapter_dropped"}  # one adapter: a swap serves the same one
    assert out["adapter_dropped"]["image_mean_abs_gap"] > 0


def test_counts_at_the_published_shapes_against_hand_counts():
    u = FULL["unet"]
    assert sum(d for _, _, _, d in X.transformers(u, 128)) == 70
    # 1024^2: 128^2 latents; CFG batch 4 = 8 rows
    a = X.attention_calls(u, 128, 8)
    assert sum(a.values()) == 140
    assert a[(8 * 10, 4096, 4096, 64)] == 2 * 2 + 3 * 2  # level 640: 2 down + 3 up transformers
    assert a[(8 * 20, 1024, 77, 64)] == 2 * 10 + 10 + 3 * 10
    lora = X.unet_lora_calls(u, 128, 8)
    assert sum(lora.values()) == 630
    assert lora[(8 * 77, 2048, 1280, False)] == 2 * 60  # attn2 k, v of the 60 blocks at 1280
    assert lora[(8 * 4096, 640, 5120, True)] == 10      # GEGLU of the 10 blocks at 640
    text = X.text_lora_calls(FULL, 4)
    assert text == {(4 * 77, 768, 768, True): 44, (4 * 77, 1280, 1280, True): 128}


def test_image_operations_against_a_hand_count():
    """The UNet's operations over one row of the CFG pair (the rule of
    ``flops.image_flops``), 20 steps, against the published shapes' hand
    count (about 6.5 TFLOP a latent a call, 77% in the transformer stacks),
    and the rest of the image within a few percent of it."""
    tr = json.loads((ROOT / "h100_bench" / "traffic" / "serve.batch_lora.json").read_text())
    total = X.image_flops(FULL, tr)
    # transformer blocks, one row at 128^2 latents: projections (q, k, v,
    # out, GEGLU 8C, ff out 4C: 2 S C^2 (4 + 8 + 4)), attention 4 S^2 C,
    # cross k/v on 77 tokens 2 * 2 * 77 * 2048 * C, cross attention 4 S 77 C
    blocks = 0
    for s, c, _, d in X.transformers(FULL["unet"], 128):
        blocks += d * (2 * s * c * c * 16 + 4 * s * s * c + 4 * 77 * 2048 * c + 4 * s * 77 * c)
    per_step = 6.5e12
    assert 0.70 < blocks / per_step < 0.85
    assert 20 * per_step * 0.95 < total < 20 * per_step * 1.15


def test_prepare_reader_reads_only_spans_with_towers():
    from h100_bench.harness import program_spans as PS

    def span(name, start, end, **attrs):
        return types.SimpleNamespace(name=name, start=start, end=end, attrs=attrs, parent=None)
    prog = PS.Program([span("server.batch", 0, 10_000_000), span("server.batch", 20, 30),
                       span("pipe.prepare", 1, 3_000_001, towers=2),
                       span("pipe.prepare", 21, 1_000_021, towers=2),
                       span("pipe.prepare", 40, 5_000_040)], 0)
    assert X.prepare_ms_per_batch({"program_spans": prog}) == pytest.approx(2.0)
    parent = PS.Program([span("server.batch", 0, 10), span("pipe.prepare", 1, 3)], 0)
    assert X.prepare_ms_per_batch({"program_spans": parent}) is None
