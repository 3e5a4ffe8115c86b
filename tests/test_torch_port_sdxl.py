"""The port's SDXL path (``pipelines/pipeline_sdxl.py``) on the CPU, held
against the benchmark's plain fp32 reference ``h100_bench/reference/sdxl.py``
(the JAX package has no SDXL).

A tiny configuration with SDXL's topology (``h100_bench/tests/tiny/
tiny_sdxl.json``: three levels, the first without attention, transformer
stacks of 1, 2 and 3 blocks, text-time conditioning, two towers, the second
projected) holds weights drawn from a seed as the benchmark draws them, so
one state dict loads into the port and into the reference.

Tolerances, with their reasons:

* the UNet and both towers, 1e-4 relative L2: both sides compute in fp32
  from the same weights and inputs; they differ only in the order of their
  sums (the reference writes attention out in query blocks, the port's
  plain attention scales q before its product), a few fp32 roundings;
* txt2img images within 1/255 at every pixel: the port rounds its image to
  bytes (half a level) and the fp32 differences above, grown over three
  Euler steps and the VAE, stay far below another half level.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.models import clip_text as tclip
from diffusion_finetuning_tpu_torch.models import unet as tunet
from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextModel
from diffusion_finetuning_tpu_torch.models.schedulers import EulerDiscreteScheduler
from diffusion_finetuning_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from diffusion_finetuning_tpu_torch.models.weights import load_module
from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline, patch_pipe
from diffusion_finetuning_tpu_torch.pipelines.pipeline_sdxl import StableDiffusionXLPipeline
from diffusion_finetuning_tpu_torch.serving import GenerationServer
from diffusion_finetuning_tpu_torch.utils import profiling

from h100_bench.harness import check as C
from h100_bench.harness import core
from h100_bench.harness import program as P
from h100_bench.reference import models as RM
from h100_bench.reference import pipeline as RP
from h100_bench.reference import sdxl as RX

ROOT = Path(__file__).resolve().parents[1]
DRV = core.load_driver(ROOT / "h100_bench" / "drivers" / "serve_sdxl.py")
TINY = json.loads((ROOT / "h100_bench" / "tests" / "tiny" / "tiny_sdxl.json").read_text())
FULL = json.loads((ROOT / "h100_bench" / "configs" / "sdxl_base.json").read_text())
SEED = 1234
REL = 1e-4
F = 2 ** (len(TINY["vae"]["block_out_channels"]) - 1)  # the VAE's factor
TRAFFIC = {"adapters": {"count": 1, "rank": 2, "up_std": 0.3, "text_lora": True}}
PROMPTS = ["a photo of a dog", "red castle in the snow at night"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def models():
    """(the reference's four fp32 modules, their state dicts)."""
    sds = {k: DRV.state_dict(k, TINY[k], SEED, torch.float32, "cpu") for k in RX.KINDS}
    ref = {}
    for k, sd in sds.items():
        m = DRV.skeleton(k, TINY[k])
        m.load_state_dict(sd, assign=True)
        ref[k] = m.eval().requires_grad_(False)
    return ref, sds


def make_pipe():
    return DRV.make_pipe(TINY, SEED, torch.float32, "cpu")


@pytest.fixture(scope="module")
def pipe():
    return make_pipe()


def ids(prompts):
    return C.ids(prompts, "cpu")


def pairs():
    return DRV.adapter_pairs(TINY, TRAFFIC, SEED, "cpu")["adapter0"]


def trees(p, sdxl_pipe):
    return {key: DRV.lora_tree(sdxl_pipe, target_set, p[k]) for k, target_set, key in DRV.TREES}


def test_unet_with_text_time_matches_reference(models):
    ref, sds = models
    cfg = P.configs(TINY)[0]
    unet = load_module(UNet2DConditionModel, cfg, sds["unet"], torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 8, 8), generator=g)
    t = torch.tensor([951.0, 1.0])
    ctx = torch.randn((2, 77, 48), generator=g)
    pooled = torch.randn((2, 32), generator=g)
    tids = torch.tensor([[64.0, 64, 0, 0, 64, 64], [32, 48, 8, 0, 64, 64]])
    before = tunet.transformer_blocks
    with torch.no_grad():
        got = unet(x, t, ctx, pooled, tids)
        want = ref["unet"](x, t, ctx, pooled, tids)
        # the added conditioning moves the output: the comparison sees it
        other = ref["unet"](x, t, ctx, pooled * 0, tids)
    assert tunet.transformer_blocks - before == 18  # stacks 2 + 3, mid 3, up 6 + 4
    assert rel_l2(got, want) < REL
    assert rel_l2(other, want) > 100 * REL
    with pytest.raises(ValueError, match="text_embeds and time_ids"):
        unet(x, t, ctx)


def test_towers_match_reference(models):
    ref, sds = models
    t1 = DRV._tower_config(tclip.CLIPTextConfig, TINY["text_encoder"])
    t2 = DRV._tower_config(tclip.CLIPTextConfig, TINY["text_encoder_2"])
    assert t1.projection_dim is None and t2.projection_dim == 32
    m1 = load_module(CLIPTextModel, t1, sds["text_encoder"], torch.float32, "cpu")
    m2 = load_module(CLIPTextModel, t2, sds["text_encoder_2"], torch.float32, "cpu")
    x = ids(PROMPTS)
    before = tclip.towers
    with torch.no_grad():
        h1 = m1(x, penultimate=True)
        h2, pooled = m2(x, penultimate=True, pooled=True)
        r1, _ = ref["text_encoder"](x)
        r2, rp = ref["text_encoder_2"](x)
    assert tclip.towers - before == 2
    assert rel_l2(h1, r1) < REL and rel_l2(h2, r2) < REL and rel_l2(pooled, rp) < REL
    assert pooled.shape == (2, 32)
    with pytest.raises(ValueError, match="projected tower"):
        m1(x, penultimate=True, pooled=True)


def reference_images(models_, p=None, merged=False, steps=3, side=32, guidance=8.0):
    ref, _ = models_
    by = {"unet": ref["unet"], "text": ref["text_encoder"], "text_2": ref["text_encoder_2"]}
    if p is not None:
        for k, m in by.items():
            (RM.merge_lora if merged else RM.attach_lora)(m, p[k])
    out = []
    try:
        for i, prompt in enumerate(PROMPTS):
            g = torch.Generator().manual_seed(100 + i)
            lat = torch.randn((4, side // F, side // F), generator=g)[None]
            x = ids([prompt])
            out.append(RX.txt2img(ref["unet"], ref["text_encoder"], ref["text_encoder_2"],
                                  ref["vae"], RX.Schedule(TINY["scheduler"]),
                                  RP.sampler("euler"), x, x, lat, guidance, steps,
                                  TINY["vae"]["scaling_factor"], F)[0].numpy())
    finally:
        for k, m in by.items():
            if p is not None and merged:
                RM.merge_lora(m, {n: (-u, d) for n, (u, d) in p[k].items()})
            RM.attach_lora(m, None)
    return np.stack(out)


def program_images(sdxl_pipe, adapter=None, steps=3, side=32, guidance=8.0):
    return sdxl_pipe(PROMPTS, height=side, width=side, num_inference_steps=steps,
                     guidance_scale=guidance, seed=[100, 101], scheduler="euler",
                     output_type="uint8", adapter_params=adapter)


def assert_within_a_level(got_u8, want):
    diff = np.abs(got_u8.astype(np.float64) / 255.0 - want)
    assert diff.max() <= 1 / 255, diff.max()


def test_txt2img_euler_zeroed_uncond_matches_reference(models, pipe):
    want = reference_images(models)
    got = program_images(pipe)
    assert got.shape == (2, 32, 32, 3) and got.std() > 0
    assert_within_a_level(got, want)


@pytest.mark.parametrize("materialize", [False, True], ids=["dynamic", "merged"])
def test_txt2img_with_an_adapter_on_all_three_models(models, pipe, materialize):
    p = pairs()
    want = reference_images(models, p, merged=materialize)
    t = trees(p, pipe)
    params = pipe.adapter_generation_params(
        unet_lora=t["unet_lora"], text_lora=t["text_encoder_lora"],
        text_lora_2=t["text_encoder_2_lora"], materialize=materialize)
    assert len(params) == 6
    got = program_images(pipe, params)
    assert_within_a_level(got, want)
    # each tree moves the image past the tolerance: the comparison sees each
    for key in ("unet_lora", "text_encoder_lora", "text_encoder_2_lora"):
        partial = {k: (v if k != key else None) for k, v in t.items()}
        other = program_images(pipe, pipe.adapter_generation_params(
            unet_lora=partial["unet_lora"], text_lora=partial["text_encoder_lora"],
            text_lora_2=partial["text_encoder_2_lora"], materialize=materialize))
        assert np.abs(other.astype(np.int64) - got.astype(np.int64)).max() > 2, key


def test_lora_targets_equal_the_reference_at_published_widths():
    """The program's SDXL targets, name for name and shape for shape, are
    the reference's defaults: 630 in the UNet, 48 and 128 in the towers."""
    ucfg, _, _, _ = P.configs(FULL)
    program = {
        "unet": (tunet.unet_lora_targets(ucfg), ""),
        "text_encoder": (tclip.text_encoder_lora_targets(
            DRV._tower_config(tclip.CLIPTextConfig, FULL["text_encoder"])),
            CLIPTextModel.lora_prefix),
        "text_encoder_2": (tclip.text_encoder_lora_targets(
            DRV._tower_config(tclip.CLIPTextConfig, FULL["text_encoder_2"])),
            CLIPTextModel.lora_prefix)}
    for kind, (targets, prefix) in program.items():
        got = sorted((tlora.module_name(t.path, prefix), t.in_features, t.out_features)
                     for t in targets)
        want = DRV.lora_targets(kind, FULL[kind])
        assert got == want, kind
    assert [len(program[k][0]) for k in program] == [630, 48, 128]
    # the canonical order: every transformer's blocks 0..depth-1 in turn
    names = [t.path[:2] for t in program["unet"][0][::9]]
    assert names[:3] == [("down_blocks_1_attentions_0", "transformer_blocks_0"),
                         ("down_blocks_1_attentions_0", "transformer_blocks_1"),
                         ("down_blocks_1_attentions_1", "transformer_blocks_0")]


def test_sd_lora_targets_keep_their_order():
    """SD 1.5's and 2.1's pair index is unchanged: one block a transformer."""
    for cfg in (UNetConfig.sd15(), UNetConfig.sd21()):
        targets = tunet.unet_lora_targets(cfg)
        assert len(targets) == 144
        assert {t.path[1] for t in targets} == {"transformer_blocks_0"}
        assert targets[0].path == ("down_blocks_0_attentions_0", "transformer_blocks_0",
                                   "attn1", "to_q")
        assert targets[-1].path == ("mid_block_attentions_0", "transformer_blocks_0",
                                    "attn2", "to_out")


def test_sdxl_base_json_builds_the_published_model():
    ucfg, vcfg, _, _ = P.configs(FULL)
    scfg = DRV.scheduler_config(FULL)
    assert ucfg == UNetConfig.sdxl() and ucfg.text_time
    assert vcfg.scaling_factor == 0.13025 and scfg.timestep_spacing == "leading"
    with torch.device("meta"):
        unet = UNet2DConditionModel(ucfg)
        t2 = CLIPTextModel(DRV._tower_config(tclip.CLIPTextConfig, FULL["text_encoder_2"]))
    blocks = sum(1 for m in unet.modules() if type(m).__name__ == "BasicTransformerBlock")
    assert blocks == 70
    assert abs(sum(p.numel() for p in unet.parameters()) - 2_567_463_684) == 0
    assert t2.text_projection.weight.shape == (1280, 1280)
    assert tclip.CLIPTextConfig.sdxl_g() == DRV._tower_config(tclip.CLIPTextConfig,
                                                              FULL["text_encoder_2"])


def test_euler_leading_grid_is_the_published_one():
    sch = EulerDiscreteScheduler(DRV.scheduler_config(FULL))
    ts = sch.timesteps(20).numpy()
    assert ts[0] == 951 and ts[-1] == 1 and np.all(np.diff(ts) == -50)
    r_ts, r_sig, r_init = RX_grid()
    assert np.array_equal(ts, np.array(r_ts, np.float32))
    state = sch.init_state(torch.zeros(1), 20)
    # the reference's sigma table is taken from alphas_cumprod rounded to
    # fp32, the port's from fp64: a few fp32 ulps apart
    assert torch.allclose(state["sigmas"], r_sig, rtol=1e-5)
    assert abs(sch.init_noise_sigma(20) - r_init) < 1e-5 * r_init
    assert abs(sch.init_noise_sigma(20) - (float(r_sig[0]) ** 2 + 1) ** 0.5) < 1e-4


def RX_grid():
    euler = RP._part("samplers", "euler")
    return euler.grid(RX.Schedule(FULL["scheduler"]), 20)


def test_trainers_and_img2img_refuse_sdxl(pipe, tmp_path):
    from diffusion_finetuning_tpu_torch.models.hf_export import save_pretrained
    from diffusion_finetuning_tpu_torch.training import train_step
    from diffusion_finetuning_tpu_torch.training_scripts import train_lora_dreambooth as db

    with pytest.raises(NotImplementedError, match="img2img"):
        pipe.img2img("a photo", np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="cannot be trained"):
        train_step.build_train_step(unet=pipe.unet, text_encoder=pipe.text_encoder,
                                    vae=pipe.vae, scheduler=None, optimizer=None,
                                    partition=None)
    d = str(tmp_path / "sdxl")
    save_pretrained(pipe, d)
    with pytest.raises(ValueError, match="text-time conditioning"):
        StableDiffusionPipeline.from_pretrained(d, device="cpu")
    args = db.parse_args(["--pretrained_model_name_or_path", d, "--instance_data_dir",
                          str(tmp_path), "--output_dir", str(tmp_path / "out"),
                          "--instance_prompt", "a photo"])
    with pytest.raises(ValueError, match="text-time conditioning"):
        db.main(args, device="cpu")


def test_diffusers_directory_round_trip_is_bit_equal(pipe, tmp_path):
    from diffusion_finetuning_tpu_torch.models.hf_export import save_pretrained

    d = str(tmp_path / "sdxl")
    pipe.tokenizer_2.pad_token = "!"
    try:
        save_pretrained(pipe, d)
    finally:
        pipe.tokenizer_2.pad_token = pipe.tokenizer_2.eos_token
    for sub in ("text_encoder_2", "tokenizer_2"):
        assert os.path.isdir(os.path.join(d, sub))
    back = StableDiffusionXLPipeline.from_pretrained(d, device="cpu")
    assert back.unet_config == pipe.unet_config and back.vae_config == pipe.vae_config
    assert back.text_config_2 == pipe.text_config_2
    assert back.text_config == dataclasses.replace(pipe.text_config)
    assert back.scheduler_config == pipe.scheduler_config
    assert back.tokenizer_2.pad_token == "!"
    for a, b in ((pipe.unet, back.unet), (pipe.vae, back.vae),
                 (pipe.text_encoder, back.text_encoder),
                 (pipe.text_encoder_2, back.text_encoder_2)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_sd_tokenizer_pads_with_end_of_text_whatever_its_map_says(pipe, tmp_path):
    """A published SD 2.x ``tokenizer/`` names "!" as its padding token in
    ``special_tokens_map.json``; the port pads SD's towers, and SDXL's tower
    1, with end-of-text, as the JAX package does.  Only SDXL's
    ``tokenizer_2`` takes the map's token."""
    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig
    from diffusion_finetuning_tpu_torch.models.hf_export import save_pretrained
    from diffusion_finetuning_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    def with_map(d):
        for sub in ("tokenizer", "tokenizer_2"):
            if os.path.isdir(os.path.join(d, sub)):
                with open(os.path.join(d, sub, "special_tokens_map.json"), "w") as f:
                    json.dump({"pad_token": {"content": "!"}}, f)

    ucfg, vcfg, tcfg = UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()
    sd = StableDiffusionPipeline(
        ucfg, UNet2DConditionModel(ucfg).state_dict(), vcfg, AutoencoderKL(vcfg).state_dict(),
        tcfg, CLIPTextModel(tcfg).state_dict(), CLIPTokenizer.tiny(["photo"]), device="cpu")
    d_sd, d_xl = str(tmp_path / "sd"), str(tmp_path / "sdxl")
    save_pretrained(sd, d_sd)
    save_pretrained(pipe, d_xl)
    with_map(d_sd)
    with_map(d_xl)
    back_sd = StableDiffusionPipeline.from_pretrained(d_sd, device="cpu")
    back_xl = StableDiffusionXLPipeline.from_pretrained(d_xl, device="cpu")
    for tok in (back_sd.tokenizer, back_xl.tokenizer):
        assert tok.pad_token == tok.eos_token == "<|endoftext|>"
        row = tok(["photo"], padding="max_length", max_length=77)["input_ids"][0]
        assert row[-1] == tok.encoder["<|endoftext|>"] != tok.encoder["!"]
    assert back_xl.tokenizer_2.pad_token == "!"


def test_adapter_file_with_text_encoder_2_pairs_round_trips(pipe, tmp_path):
    """save_all writes the three trees as one safetensors file; patch_pipe
    installs them, tower 2's among them, bit for bit; an SD pipe reading
    the file skips the pairs it has no tower for."""
    t = trees(pairs(), pipe)
    path = str(tmp_path / "sdxl_adapter.safetensors")
    tlora.save_all(t["unet_lora"], t["text_encoder_lora"],
                   pipe.lora_targets("unet", tlora.UNET_DEFAULT_TARGET_REPLACE),
                   pipe.lora_targets("text_encoder", tlora.TEXT_ENCODER_DEFAULT_TARGET_REPLACE),
                   None, path, save_ti=False, text_2_lora=t["text_encoder_2_lora"],
                   text_2_targets=pipe.lora_targets("text_encoder_2",
                                                    tlora.TEXT_ENCODER_DEFAULT_TARGET_REPLACE))
    other = make_pipe()
    patch_pipe(other, path, patch_text=True)
    for key in ("unet_lora", "text_encoder_lora", "text_encoder_2_lora"):
        got = dict(tlora.lora_leaves(getattr(other, key)))
        want = dict(tlora.lora_leaves(t[key]))
        assert got.keys() == want.keys(), key
        for path_, leaf in want.items():
            assert torch.equal(got[path_]["up"], leaf["up"])
            assert torch.equal(got[path_]["down"], leaf["down"])
    # the installed trees generate as the explicit ones do
    other.materialize_lora = False
    explicit = pipe.adapter_generation_params(
        unet_lora=t["unet_lora"], text_lora=t["text_encoder_lora"],
        text_lora_2=t["text_encoder_2_lora"], materialize=False)
    assert np.array_equal(program_images(other), program_images(pipe, explicit))


def test_server_routes_an_adapter_with_three_trees(pipe):
    t = trees(pairs(), pipe)
    server = GenerationServer(pipe, max_batch=2)
    try:
        server.register_adapter("a", t, materialize=False)
        futs = [server.submit(p, height=32, width=32, steps=2, guidance_scale=8.0,
                              scheduler="euler", seed=100 + i, adapter="a")
                for i, p in enumerate(PROMPTS)]
        served = np.stack([np.asarray(f.result(timeout=300)) for f in futs])
    finally:
        server.close()
    want = pipe(PROMPTS, height=32, width=32, num_inference_steps=2, guidance_scale=8.0,
                seed=[100, 101], scheduler="euler", output_type="uint8",
                adapter_params=pipe.adapter_generation_params(
                    unet_lora=t["unet_lora"], text_lora=t["text_encoder_lora"],
                    text_lora_2=t["text_encoder_2_lora"], materialize=False))
    assert np.array_equal(served, want)


def test_negative_prompts_encode_and_empty_rows_zero(pipe):
    """A written negative prompt is encoded; an empty one in the same batch
    is zeros, as a batch of empty ones is (another graph key)."""
    kw = dict(height=32, width=32, num_inference_steps=2, scheduler="euler",
              output_type="uint8", seed=[100, 101])
    zeroed = pipe(PROMPTS, **kw)
    mixed = pipe(PROMPTS, negative_prompt=["", "blurry"], **kw)
    assert np.array_equal(mixed[0], zeroed[0])
    assert not np.array_equal(mixed[1], zeroed[1])


def test_condition_span_counters_and_prepare_towers(pipe):
    profiling.clear()
    blocks, towers = tunet.transformer_blocks, tclip.towers
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pipe(PROMPTS[:1], height=32, width=32, num_inference_steps=2, scheduler="euler",
             output_type="uint8")
    spans = profiling.spans()
    cond = [s for s in spans if s.name == "pipe.condition"]
    prep = [s for s in spans if s.name == "pipe.prepare"]
    assert len(cond) == 1 and cond[0].attrs == {"towers": 2, "rows": 1, "zeroed_uncond": True}
    assert len(prep) == 1 and prep[0].attrs["towers"] == 2
    assert tunet.transformer_blocks - blocks == 2 * 18
    assert tclip.towers - towers == 2
    profiling.clear()


def test_dispatch_log_reads_the_new_counters():
    from diffusion_finetuning_tpu_torch.training.trainer_util import DispatchLog

    log = DispatchLog("x", torch.device("cpu"))
    tunet.transformer_blocks += 70
    tclip.towers += 2
    log.tick(torch.zeros(1), 1)
    out = log.summary()
    assert out["transformer_blocks"] == 70 and out["text_towers"] == 2


def test_chip_smoke_sdxl_rows_hold_the_cells_calls():
    """``chip_smoke.py`` phase 2's SDXL rows time K1 and K2 at the calls
    ``harness/sdxl_flops.py`` counts for a CFG UNet step of 4 images at
    1024^2 (8 rows) and for a request's towers, and the NHWC GroupNorm at
    that step's and the 1024^2 decode's shapes."""
    import chip_smoke as cs
    from diffusion_finetuning_tpu_torch.models.vae import VAEConfig
    from h100_bench.harness import sdxl_flops as X

    u = FULL["unet"]
    assert {r[:4]: r[4] for r in cs.SDXL_FLASH} == X.attention_calls(u, 128, 8)
    unet = {}
    for (m, k, n, _), c in X.unet_lora_calls(u, 128, 8).items():
        unet[(m, k, n)] = unet.get((m, k, n), 0) + c
    assert {r[:3]: r[3] for r in cs.SDXL_LORA} == unet
    assert {r[:3]: r[3] for r in cs.SDXL_TOWER_LORA} == {
        key[:3]: c for key, c in X.text_lora_calls(FULL, 4).items()}
    assert [s[2:] for s in cs.SDXL_GN_SETS] == [("sdxl", 8, 128), ("sdxl_vae", 4, 128)]
    assert (4, 128, 1024, 1024, False, True) in cs.vae_decoder_group_norm_calls(
        VAEConfig.sdxl(), 4, 128)
