"""The benchmark harness on the CPU: the cells resolve by name, traffic is
a function of the seed, the operation counts agree with hand counts, the
JAX guard, tiny runs of every driver, and runs with the timed path broken
underneath that must come out not correct."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from conftest import ROOT
from h100_bench.harness import core, flops, runner
from h100_bench.harness import weights as W

serve = core.load_driver(ROOT / "h100_bench" / "drivers" / "serve.py")
train = core.load_driver(ROOT / "h100_bench" / "drivers" / "train.py")

TINY = ROOT / "h100_bench" / "tests" / "tiny"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
E2E = [{"name": n, "unit": u} for n, u in (("setup_s", "s"), ("latency_p90_s", "s"),
                                           ("images_per_s", "images/s"),
                                           ("train_samples_per_s", "samples/s"))]


def tiny_ctx(traffic, seed=20_000_000_011, seconds=2.0, trace=False, cell=None):
    cfg = json.loads((TINY / "tiny.json").read_text())
    tr = json.loads((TINY / f"{traffic}.json").read_text())
    spec = core.resolve(BENCH, cell) if cell else {"per_layer": [], "readers": {}}
    return runner.Ctx(workload=cell or "tiny", seed=seed, seconds=seconds, trace=trace,
                      device=torch.device("cpu"), config=cfg, traffic=tr, end_to_end=E2E,
                      per_layer=spec["per_layer"], readers=spec["readers"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    spec = core.resolve(BENCH, cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["driver"].is_file()
    drv = core.load_driver(spec["driver"])
    assert all(callable(getattr(drv, f)) for f in ("Run", "checks", "readings"))
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for path in spec["readers"].values():
        assert callable(core.load_reader(path))
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A dummy configuration, traffic mix and metric, added as files and
    entries, resolve without an edit to any file that is there."""
    bench_dir = tmp_path / "h100_bench"
    shutil.copytree(ROOT / "h100_bench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench_dir / "configs" / "dummy.json").write_text((TINY / "tiny.json").read_text())
    (bench_dir / "traffic" / "serve.dummy.json").write_text(
        (TINY / "serve.adapters_open.json").read_text())
    (bench_dir / "metrics" / "dummy_share.serve_dummy.py").write_text(
        "def read(m):\n    return 42.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "h100_bench/configs/dummy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy.serve.dummy", "config": "dummy",
                               "traffic": "serve.dummy", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_share.serve_dummy", "unit": "%",
                               "better": "higher", "source": "program_span",
                               "layer": "server", "moves": "latency_p90_s",
                               "workloads": ["dummy.serve.dummy"]})
    bench["end_to_end"][1]["workloads"].append("dummy.serve.dummy")
    spec = core.resolve(bench, "dummy.serve.dummy", bench_dir)
    assert spec["traffic"]["arrival"] == "open"
    assert [m["name"] for m in spec["per_layer"]] == ["dummy_share.serve_dummy"]
    assert core.load_reader(spec["readers"]["dummy_share.serve_dummy"])({}) == 42.0


DUMMY_DRIVER = '''"""A driver of one fixed number a second, for the harness test."""
from h100_bench.harness import check as C


class Run:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        self.value = self.ctx.traffic["value"]

    def window(self):
        self.t_open = 0.0

    def end_to_end(self):
        return {"attempted": 1, "failed": 0, "latency_p90_s": self.value}

    def check_inputs(self):
        return {"value": self.value}

    control_inputs = check_inputs

    def close(self):
        pass


def checks(ctx, inputs):
    return C.held({"gap": abs(inputs["value"] - 1.0)}, ctx.traffic["check"]["limits"], ["gap"])


def readings(ctx, inputs, mode):
    return {"gap": 0.0}, {"gap": 1.0}
'''


@pytest.mark.parametrize("value, correct", [(1.0, True), (3.0, False)])
def test_a_new_driver_runs_from_new_files_alone(tmp_path, value, correct):
    """A new kind of traffic: its driver file, its traffic file and the
    cell's entries run through the harness with no file that is there
    edited."""
    bench_dir = tmp_path / "h100_bench"
    shutil.copytree(ROOT / "h100_bench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench_dir / "drivers" / "fixed.py").write_text(DUMMY_DRIVER)
    (bench_dir / "traffic" / "fixed.one.json").write_text(json.dumps(
        {"driver": "fixed", "value": value, "check": {"limits": {"gap": 0.5}}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "sd15.fixed.one", "config": "sd15",
                               "traffic": "fixed.one", "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("sd15.fixed.one")
    spec = core.resolve(bench, "sd15.fixed.one", bench_dir)
    assert spec["driver"] == bench_dir / "drivers" / "fixed.py"
    ctx = runner.Ctx(workload="sd15.fixed.one", seed=1, seconds=1.0, trace=False,
                     device=torch.device("cpu"), config=spec["config"], traffic=spec["traffic"],
                     end_to_end=spec["end_to_end"], per_layer=[], readers={},
                     driver=spec["driver"])
    out = _run(ctx)
    assert out["correct"] is correct
    assert out["metrics"]["latency_p90_s"] == (value, "s")
    assert [c[0] for c in out["checks"]] == ["gap"]


def test_an_unknown_driver_or_sampler_stops_the_run():
    with pytest.raises(SystemExit):
        core.driver_path({"driver": "../serve"})
    ctx = tiny_ctx("serve.adapters_open")
    ctx.traffic["scheduler"] = "euler_a"  # a sampler the reference does not have yet
    with pytest.raises(ValueError, match="sampler"):
        serve.Run(ctx)
    from h100_bench.reference import pipeline as RP

    with pytest.raises(ValueError, match="no beta"):
        RP.Schedule({"num_train_timesteps": 10, "beta_schedule": "cosine", "beta_start": 0.1,
                     "beta_end": 0.2, "prediction_type": "epsilon", "set_alpha_to_one": False})


def test_images_per_s_counts_whole_batches_after_the_first():
    """Four batches of 4 finishing at 1, 2, 3, 4 s (their images a few
    microseconds apart): 12 images over 3 s, not 15."""
    ok, batch_of = [], {}
    for b in range(4):
        for i in range(4):
            seed = 10 * b + i
            batch_of[seed] = b
            ok.append({"req": {"seed": seed}, "done": 1.0 + b + 1e-6 * i})
    assert serve.batch_rate(ok, batch_of, 0.5, 10.0) == pytest.approx(12 / 3.0)
    assert serve.batch_rate(ok, batch_of, 2.5, 10.0) == pytest.approx(4 / 1.0)
    assert serve.batch_rate(ok, batch_of, 3.5, 10.0) is None


def _trace(launches, records):
    """A trace whose device records are (name, correlation) in order."""
    from h100_bench.harness.trace import Trace

    kernels = [(n, float(i), i + 0.5) for i, (n, _) in enumerate(records)]
    return Trace(kernels, [], 0.0, float(len(records)), [c for _, c in records], launches)


def test_lost_device_records_are_found_by_the_launch_records():
    graph = ["gemm", "lora_dense", "norm", "lora_dense"]
    records = [(n, c) for c in (1, 2, 3) for n in graph] + [("copy", 9)]
    launches = [("graph", 1), ("graph", 2), ("graph", 3), ("kernel", 9)]
    assert _trace(launches, records).lost_records()["graph_launches_short"] == 0
    # one record of launch 2 dropped
    dropped = [r for r in records if r != ("lora_dense", 2)][:-1] + [("copy", 9)]
    assert _trace(launches, dropped).lost_records()["graph_launches_short"] == 1
    # a kernel launch with no record
    lost = _trace(launches + [("kernel", 10)], records).lost_records()
    assert lost["kernel_launches_lost"] == 1
    assert _trace([], records).lost_records() is None


def test_the_roofline_is_never_rescaled():
    """One call's bound over the kernel's whole time, however many
    launches a call takes; no reading where records were lost."""
    from h100_bench.harness import readers as R

    def lora_dense(name):
        return name == "lora_dense"
    graph = ["gemm", "lora_dense", "norm", "lora_dense"]
    records = [(n, c) for c in (1, 2, 3) for n in graph]
    m = {"trace": _trace([("graph", c) for c in (1, 2, 3)], records)}
    # six launches of 0.5 s: 3 s; bound 1.5 s over 3 calls
    assert R.roofline(m, lora_dense, 1.5, 3) == pytest.approx(50.0)
    fused = [(n, c) for c in (1, 2, 3) for n in ["gemm", "lora_dense", "norm"]]
    m = {"trace": _trace([("graph", c) for c in (1, 2, 3)], fused)}
    assert R.roofline(m, lora_dense, 1.5, 3) == pytest.approx(100.0)
    dropped = [r for r in records if r != ("lora_dense", 2)]
    m = {"trace": _trace([("graph", c) for c in (1, 2, 3)], dropped)}
    assert R.roofline(m, lora_dense, 1.5, 3) is None


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from h100_bench.reference import numerics

    x = torch.randn(4096, dtype=torch.float32)
    y = numerics._tf32(x)
    assert int((y.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((y - x).abs() / x.abs()).max()) <= 2.0 ** -11 * (1 + 1e-6)
    with numerics.precision("tf32"):
        assert not torch.equal(numerics.act(x), x)


@pytest.mark.parametrize("name", ["serve.adapters_open", "serve.batch_merged"])
def test_serve_schedule_is_a_function_of_the_seed(name):
    tr = json.loads((ROOT / "h100_bench" / "traffic" / f"{name}.json").read_text())
    a = serve.schedule(tr, 2 ** 31 + 7, 45)
    assert a == serve.schedule(tr, 2 ** 31 + 7, 45)
    b = serve.schedule(tr, 2 ** 31 + 8, 45)
    assert [r["seed"] for r in a] != [r["seed"] for r in b]
    assert [r["prompt"] for r in a] != [r["prompt"] for r in b]
    # the same work arrives at the same times for every seed
    assert [(r["due"], r["adapter"]) for r in a] == [(r["due"], r["adapter"]) for r in b]
    if tr["arrival"] == "open":
        gaps = np.diff([r["due"] for r in a])
        assert len(a) == round(tr["rate_per_s"] * 45) and gaps.std() > 0.5 * gaps.mean()


def test_train_draws_are_a_function_of_the_seed():
    a = train.draws_for(5_000_000_000, 3, 1, 8, "cpu")
    b = train.draws_for(5_000_000_000, 3, 1, 8, "cpu")
    c = train.draws_for(5_000_000_001, 3, 1, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["noise"], c["noise"])


def test_weights_are_a_function_of_the_seed():
    cfg = json.loads((TINY / "tiny.json").read_text())
    a = W.state_dict("vae", cfg["vae"], 9, torch.float32, "cpu")
    b = W.state_dict("vae", cfg["vae"], 9, torch.float32, "cpu")
    c = W.state_dict("vae", cfg["vae"], 10, torch.float32, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "decoder.conv_in.weight"
    assert not torch.equal(a[w], c[w])
    bound = a[w][0].numel() ** -0.5
    assert float(a[w].abs().max()) <= bound


def test_attention_and_lora_counts_against_hand_counts():
    # one attention call: B*H = 16, Sq = Skv = 4096, d = 40, bf16
    f, b = flops.k1_cost(16, 4096, 4096, 40, 2)
    assert f == 2 * (16 * 4096 * 4096 * 40) * 2            # QK^T and PV, 2 ops a MAC
    assert b == 2 * 16 * 40 * (4096 * 2 + 4096 * 2) + 4 * 16 * 4096  # q, o, k, v; lse fp32
    f, _ = flops.k3_cost(8, 1024, 77, 80, 2)
    assert f == 4 * 2 * 8 * 1024 * 77 * 80                  # dV, dP, dQ, dK
    # one LoRA dense call: M = 8192, K = N = 320, rank 4, bias
    f, b = flops.k2_cost(8192, 320, 320, 4, 2, True)
    assert f == 2 * 8192 * 320 * 320 + 2 * 8192 * 320 * 4 + 2 * 8192 * 4 * 320
    assert b == 2 * (8192 * 320 + 320 * 320 + 8192 * 320 + 320 + 320 * 4 + 4 * 320) + 4


def test_conv_count_against_hand_count():
    from h100_bench.reference import models as RM

    with torch.device("meta"):
        conv = RM.Conv2d(320, 640, 3, padding=1)
        x = torch.empty(2, 320, 64, 64)
    got = flops._count(lambda: conv(x))
    assert got == 2 * 2 * 640 * 64 * 64 * 320 * 9


# frozen copies of chip_smoke.py's SD1.5 shape lists (CFG batch 2 at 512^2)
FLASH_SHAPES = [(4096, 4096, 40, 5), (1024, 1024, 80, 5), (256, 256, 160, 5), (64, 64, 160, 1),
                (4096, 77, 40, 5), (1024, 77, 80, 5), (256, 77, 160, 5), (64, 77, 160, 1)]
LORA_SHAPES = []
for _m, _c, _n in ((8192, 320, 5), (2048, 640, 5), (512, 1280, 5), (128, 1280, 1)):
    LORA_SHAPES += [(_m, _c, _c, 6 * _n), (154, 768, _c, 2 * _n), (_m, _c, 8 * _c, _n)]


def test_call_lists_from_the_configuration_match_chip_smoke():
    cfg = json.loads((ROOT / "h100_bench" / "configs" / "sd15.json").read_text())
    att = flops.attention_calls(cfg["unet"], 64, 2)
    assert att == {(16, sq, skv, d): n for sq, skv, d, n in FLASH_SHAPES}
    lora = {}
    for (m, k, n, _), c in flops.unet_lora_calls(cfg["unet"], 64, 2).items():
        lora[(m, k, n)] = lora.get((m, k, n), 0) + c
    want = {}
    for m, k, n, c in LORA_SHAPES:
        want[(m, k, n)] = want.get((m, k, n), 0) + c
    assert lora == want


def test_import_guard_compares_whole_top_level_names():
    assert core.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert core.forbidden_modules(["diffusion_finetuning_tpu.models"]) == [
        "diffusion_finetuning_tpu"]
    assert core.forbidden_modules(["diffusion_finetuning_tpu_torch.ops", "flax_x"]) == []
    assert core.forbidden_modules(["optax", "jaxlib"]) == ["jaxlib", "optax"]


def test_tokenizer_matches_the_programs():
    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from h100_bench.reference import tokenizer as RT

    vocab, merges = W.tokenizer_tables()
    rng = np.random.default_rng(3)
    prompts = [W.prompt(rng, int(n)) for n in rng.integers(1, 30, 20)] + [""]
    want = CLIPTokenizer(vocab, merges)(prompts, padding="max_length", truncation=True,
                                        max_length=77)["input_ids"]
    assert RT.encode(prompts, vocab, merges) == [list(map(int, r)) for r in want]


def _run(ctx):
    return runner.run_cell(ctx, time.perf_counter())


@pytest.mark.parametrize("traffic", ["serve.adapters_open", "serve.batch_merged",
                                     "train.dreambooth_fp32"])
def test_tiny_run_of_each_driver_is_correct(traffic):
    out = _run(tiny_ctx(traffic))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]


def test_tiny_traced_run_reads_the_host_spans():
    out = _run(tiny_ctx("serve.adapters_open", trace=True, cell="sd15.serve.adapters_open"))
    assert out["correct"]
    m = out["metrics"]
    assert 0 < m["batch_occupancy.serve_open"][0] <= 100
    assert m["queue_wait_p90_s.serve_open"][0] >= 0
    assert "idle_share.serve_open" not in m  # no device kernels on the CPU


def test_a_step_that_keeps_its_state_is_not_correct(monkeypatch):
    from diffusion_finetuning_tpu_torch.training import optim

    monkeypatch.setattr(optim.MultiGroupOptimizer, "step",
                        lambda self, state: torch.ones((), dtype=torch.bool))
    out = _run(tiny_ctx("train.dreambooth_fp32"))
    assert not out["correct"]
    bad = {c[0] for c in out["checks"] if not c[3]}
    assert {"grad_norm_gap", "change_norm_gap"} <= bad


def test_an_altered_loss_is_not_correct(monkeypatch):
    from diffusion_finetuning_tpu_torch.training import train_step

    real = train_step.loss_step
    monkeypatch.setattr(train_step, "loss_step", lambda *a, **k: real(*a, **k) * 1.5)
    out = _run(tiny_ctx("train.dreambooth_fp32"))
    assert not out["correct"]
    assert "loss_gap" in {c[0] for c in out["checks"] if not c[3]}


@pytest.mark.parametrize("traffic", ["serve.adapters_open", "serve.batch_merged"])
def test_an_altered_image_is_not_correct(monkeypatch, traffic):
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline

    real = StableDiffusionPipeline._decode
    monkeypatch.setattr(StableDiffusionPipeline, "_decode",
                        lambda self, x: 255 - real(self, x))
    out = _run(tiny_ctx(traffic))
    assert not out["correct"]


@pytest.mark.parametrize("traffic", ["serve.adapters_open", "train.dreambooth_fp32"])
def test_the_control_reads_above_the_program(traffic):
    """The control (the reference one precision down, in the program's
    place) at a tiny size: it reads further from the fp32 reference than
    the fp32 program does."""
    from h100_bench.tools import controls

    ctx = tiny_ctx(traffic)
    prog, ctrl = controls.readings(ctx, ctx.traffic["check"]["control"])
    key = "image_mean_abs_gap" if "serve" in traffic else "loss_gap"
    assert ctrl[key] > 3 * prog[key], (prog, ctrl)


def test_adapter_faults_read_at_a_tiny_size():
    ctx = tiny_ctx("serve.adapters_open")
    out = serve.adapter_faults(ctx, 2)
    assert set(out) == {"adapter_swapped", "adapter_dropped"}
    assert all(v["image_mean_abs_gap"] > 0 for v in out.values())


@pytest.mark.h100_card
def test_cells_control_on_the_card(card):
    """The controls at the cells' own sizes (``python -m
    h100_bench.tools.controls``), on the card only."""
    from h100_bench.tools import controls

    assert controls.main(["--seeds", "1", "--cells", BENCH["workloads"][0]["name"]]) == 0
