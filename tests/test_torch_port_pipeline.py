"""The port's txt2img and img2img slices as a whole against the JAX
pipeline, on the CPU.

Both pipelines get the same tiny weights (the port's through its weight
bridge), the same ``CLIPTokenizer.tiny`` and the same given latents (for
img2img, JAX's two draws handed to the port), and run 3 DDIM steps with CFG
(txt2img with a rank-2 UNet LoRA, non-zero up, merged and dynamic).  Their
uint8 images agree within 1/255: the same fp32 value may round to
neighbouring uint8 levels on the two sides.

The UNet with both kernel switches on (the fused 3x3 conv and head-packed
flash attention, through their plain versions here) is held against the
JAX UNet at a config built here, wide enough (64 and 128 channels, 16^2
latents) for the conv routing to accept its resnet convs at two levels:
the tiny config's 8-16 channels never pass it.  Tolerance 1e-4, as for the
other whole-model comparisons.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu import lora as jlora
from diffusion_finetuning_tpu.models import unet as junet
from diffusion_finetuning_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
from diffusion_finetuning_tpu.models.clip_text import CLIPTextConfig as JClip
from diffusion_finetuning_tpu.models.schedulers import SchedulerConfig as JSched
from diffusion_finetuning_tpu.models.unet import UNetConfig as JUNet
from diffusion_finetuning_tpu.models.vae import VAEConfig as JVAE
from diffusion_finetuning_tpu.pipelines.pipeline import StableDiffusionPipeline as JaxPipe

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
from diffusion_finetuning_tpu_torch.models import layers as tlayers
from diffusion_finetuning_tpu_torch.models import unet as tunet
from diffusion_finetuning_tpu_torch.models import weights
from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig
from diffusion_finetuning_tpu_torch.models.schedulers import SchedulerConfig
from diffusion_finetuning_tpu_torch.models.unet import UNetConfig
from diffusion_finetuning_tpu_torch.models.vae import VAEConfig
from diffusion_finetuning_tpu_torch.ops import conv3x3 as tconv
from diffusion_finetuning_tpu_torch.ops import flash_attention as tfa
from diffusion_finetuning_tpu_torch.pipelines.pipeline import (
    StableDiffusionPipeline, img2img_start)

from tests.jitutil import jit_apply, jit_init
from tests.torch_port_fixtures import numpy_lora_tree, tiny_params, to_jax, to_numpy

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

WORDS = ["photo", "of", "sks"]
PROMPTS = ["a photo of sks", "photo"]


def _port_pipe(device="cpu"):
    unet_p, vae_p, text_p = tiny_params()
    return StableDiffusionPipeline(
        UNetConfig.tiny(), weights.unet_state_dict(unet_p, JUNet.tiny()),
        VAEConfig.tiny(), weights.vae_state_dict(vae_p, JVAE.tiny()),
        CLIPTextConfig.tiny(), weights.text_state_dict(text_p, JClip.tiny()),
        CLIPTokenizer.tiny(WORDS), SchedulerConfig(), device=device)


@pytest.fixture(scope="module")
def pipes():
    unet_p, vae_p, text_p = tiny_params()
    jpipe = JaxPipe(JUNet.tiny(), to_jax(unet_p), JVAE.tiny(), to_jax(vae_p),
                    JClip.tiny(), to_jax(text_p), JaxTokenizer.tiny(WORDS), JSched())
    return jpipe, _port_pipe()


def _latents():
    return np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32)


@pytest.mark.parametrize("materialize", [True, False], ids=["merged", "dynamic"])
def test_txt2img_matches_jax(pipes, materialize):
    jpipe, tpipe = pipes
    targets = jpipe.lora_targets("unet", jlora.DEFAULT_TARGET_REPLACE)
    assert [t.path for t in targets] == [
        t.path for t in tpipe.lora_targets("unet", jlora.DEFAULT_TARGET_REPLACE)]
    lora_np = numpy_lora_tree(targets, seed=11, amp=0.5)
    jpipe.unet_lora, tpipe.unet_lora = to_jax(lora_np), weights.lora_tree_to_torch(lora_np)
    jpipe.materialize_lora = tpipe.materialize_lora = materialize
    kw = dict(height=16, width=16, num_inference_steps=3, guidance_scale=7.5,
              output_type="np")
    want = jpipe(PROMPTS, latents=jnp.asarray(_latents()), **kw)
    got = tpipe(PROMPTS, latents=_latents(), **kw)
    assert got.shape == want.shape == (2, 16, 16, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
    # the LoRA is on the path: without it the images differ
    tpipe.unet_lora = None
    base = tpipe(PROMPTS, latents=_latents(), **kw)
    assert np.abs(base - got).max() > 2.0 / 255


def _init_image():
    return np.random.default_rng(5).integers(0, 256, (16, 16, 3), dtype=np.uint8)


def test_img2img_matches_jax(pipes):
    """img2img, strength 0.75 over 4 DDIM steps: both start at step 1
    (t_start = round(0.25 * 4)) and run 3 UNet steps; the port gets JAX's
    encoder-sample and noise draws."""
    jpipe, tpipe = pipes
    jpipe.unet_lora = tpipe.unet_lora = None
    seed, steps = 3, 4
    starts = []
    real = jpipe._img2img_fn

    def spy(num_steps, t_start, *rest):
        starts.append(t_start)
        return real(num_steps, t_start, *rest)

    jpipe._img2img_fn = spy
    try:
        kw = dict(strength=0.75, num_inference_steps=steps, guidance_scale=7.5, seed=seed,
                  output_type="np")
        want = jpipe.img2img(PROMPTS, _init_image(), **kw)
    finally:
        jpipe._img2img_fn = real
    r_enc, r_noise = jax.random.split(jax.random.PRNGKey(seed))
    draws = {"sample": np.asarray(jax.random.normal(r_enc, (1, 8, 8, 4), jnp.float32)),
             "noise": np.asarray(jax.random.normal(r_noise, (2, 8, 8, 4), jnp.float32))}
    calls = []
    hook = tpipe.unet.register_forward_hook(lambda *a: calls.append(1))
    try:
        got = tpipe.img2img(PROMPTS, _init_image(), draws=draws, **kw)
    finally:
        hook.remove()
    assert starts == [img2img_start(steps, 0.75)] == [1] and len(calls) == steps - 1
    assert got.shape == want.shape == (2, 16, 16, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
    # a [0, 1] float image is the same input as its uint8 levels
    again = tpipe.img2img(PROMPTS, _init_image().astype(np.float32) / 255.0, draws=draws, **kw)
    np.testing.assert_array_equal(again, got)


def test_img2img_seeded_draws_and_start():
    """Without draws the two come from the seed; t_start rounds half to
    even (0.75 at 50 steps: step 12, 38 UNet steps) and stays inside the
    grid; an unknown sampler raises JAX's ``_build_img2img_fn`` error."""
    assert [img2img_start(n, s) for n, s in ((50, 0.75), (4, 0.75), (10, 0.0), (10, 1.0))] == [
        12, 1, 9, 0]
    tpipe = _port_pipe()
    d1, d2 = tpipe.img2img_draws(7, 2, (8, 8)), tpipe.img2img_draws(7, 2, (8, 8))
    assert d1["sample"].shape == (1, 8, 8, 4) and d1["noise"].shape == (2, 8, 8, 4)
    assert torch.equal(d1["noise"], d2["noise"])
    kw = dict(num_inference_steps=2, seed=7, output_type="uint8")
    a = tpipe.img2img("photo", _init_image(), **kw)
    b = tpipe.img2img("photo", _init_image(), draws=tpipe.img2img_draws(7, 1, (8, 8)), **kw)
    assert a.dtype == np.uint8 and a.shape == (1, 16, 16, 3)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="img2img supports ddim / pndm / dpm"):
        tpipe.img2img("photo", _init_image(), scheduler="euler_b", **kw)


WIDE_UNET = dict(sample_size=16, block_out_channels=(64, 128), layers_per_block=1,
                 cross_attention_dim=32, attention_head_dim=2, norm_num_groups=8,
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))


def test_unet_with_kernel_switches_on_matches_jax(monkeypatch):
    """Both switches on (DFT_CONV_PALLAS, DFT_FLASH_HEAD_PACK=2) with a LoRA
    on the attention, GEGLU and resnet-conv targets: every 3x3 resnet conv
    at 16^2 and 8^2 runs the fused conv's plain version (the LoRA down/up
    convs never do), every attention call the packed forward's."""
    jcfg, tcfg = junet.UNetConfig(**WIDE_UNET), tunet.UNetConfig(**WIDE_UNET)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([981, 1], np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    params = to_numpy(jit_init(junet.UNet2DConditionModel(jcfg))(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))["params"])
    lora_np = numpy_lora_tree(jlora.filter_targets(junet.unet_all_lora_targets(jcfg),
                                                   jlora.UNET_EXTENDED_TARGET_REPLACE),
                              seed=4, amp=0.1)
    want = jit_apply(junet.UNet2DConditionModel(jcfg))(
        {"params": to_jax(params), "lora": to_jax(lora_np)},
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))

    port = tunet.UNet2DConditionModel(tcfg)
    port.load_state_dict(weights.to_torch(weights.unet_state_dict(params, jcfg),
                                          torch.float32), strict=True)
    monkeypatch.setattr(tlayers, "CONV_KERNEL", True)
    monkeypatch.setattr(tfa, "DEFAULT_HEAD_PACK", 2)
    convs, packed = [], []
    real_conv, real_packed = tconv.conv3x3_plain, tfa.flash_attention_plain_packed
    monkeypatch.setattr(tconv, "conv3x3_plain",
                        lambda x, *a: convs.append(tuple(x.shape)) or real_conv(x, *a))
    monkeypatch.setattr(tfa, "flash_attention_plain_packed",
                        lambda q, *a: packed.append(q.shape) or real_packed(q, *a))
    with torch.no_grad(), tlora.attached(port, weights.lora_tree_to_torch(lora_np)):
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t).long(),
                   torch.from_numpy(ctx)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    # 8 resnets (down 1 + 1, mid 2, up 2 + 2) x 2 convs, all routed;
    # 4 transformer blocks (down 1, mid 1, up 2) x 2 attention calls
    assert len(convs) == 16 and {s[2] for s in convs} == {16, 8}
    assert len(packed) == 8


def test_encode_prompt_matches_jax(pipes):
    jpipe, tpipe = pipes
    want = np.asarray(jpipe.encode_prompt(PROMPTS))
    got = tpipe.encode_prompt(PROMPTS).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_seeds_give_per_sample_latents(pipes):
    """Without given latents each prompt draws from its own seeded
    generator: an image depends on its seed, not on its batch position."""
    _, tpipe = pipes
    tpipe.unet_lora = None
    kw = dict(height=16, width=16, num_inference_steps=2, output_type="uint8")
    pair = tpipe(["photo", "photo"], seed=[3, 4], **kw)
    single = tpipe("photo", seed=4, **kw)
    assert pair.dtype == np.uint8 and pair.shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(pair[1], single[0])
    assert np.abs(pair[0].astype(int) - pair[1].astype(int)).max() > 0


def test_merged_cache_follows_tree_identity(pipes):
    jpipe, tpipe = pipes
    targets = tpipe.lora_targets("unet", jlora.DEFAULT_TARGET_REPLACE)
    tpipe.materialize_lora = True
    tpipe.unet_lora = weights.lora_tree_to_torch(numpy_lora_tree(targets, seed=12))
    first = tpipe._generation_params()[0]
    assert tpipe._generation_params()[0] is first and len(first) == len(targets)
    from diffusion_finetuning_tpu_torch import lora as tlora

    tpipe.unet_lora = tlora.tune_lora_scale(tpipe.unet_lora, 0.0)
    zeroed = tpipe._generation_params()[0]
    assert zeroed is not first
    for name, w in zeroed.items():  # scale 0 folds nothing in
        torch.testing.assert_close(w, tpipe.unet.get_parameter(name))
    tpipe.unet_lora = None


def test_merged_weights_are_cached_for_tap_major(pipes):
    """Merged weights built inside the generation entry points'
    ``torch.inference_mode()`` are ordinary tensors that need no grad, so
    the fused conv's tap-major copy of a merged resnet conv weight is made
    once and found again on the next call."""
    _, tpipe = pipes
    targets = tpipe.lora_targets("unet", tlora.UNET_EXTENDED_TARGET_REPLACE)
    assert any(t.is_conv for t in targets)
    tpipe.materialize_lora = True
    tpipe.unet_lora = weights.lora_tree_to_torch(numpy_lora_tree(targets, seed=13))
    try:
        with torch.inference_mode():
            merged = tpipe._generation_params()[0]
            assert tpipe._generation_params()[0] is merged
        assert len(merged) == len(targets)
        for w in merged.values():
            assert not w.is_inference() and not w.requires_grad
        convs = [w for w in merged.values() if w.ndim == 4 and w.shape[2:] == (3, 3)]
        assert convs
        copies = tconv.tap_major_copies
        with torch.inference_mode():
            first = [tconv.tap_major(w) for w in convs]
            again = [tconv.tap_major(w) for w in convs]
        assert all(a is b for a, b in zip(first, again))
        assert tconv.tap_major_copies == copies + len(convs)
    finally:
        tpipe.unet_lora = None


def test_superseded_merged_set_is_freed_before_the_next_is_built(pipes, monkeypatch):
    """A swap never holds two merged sets: the installed slot's superseded
    set, and the adapter LRU's eldest, are gone when the merge of their
    successor starts (weak references to them are dead inside it)."""
    import weakref

    from diffusion_finetuning_tpu_torch.pipelines import pipeline as tpipeline

    _, tpipe = pipes
    targets = tpipe.lora_targets("unet", jlora.DEFAULT_TARGET_REPLACE)
    trees = [weights.lora_tree_to_torch(numpy_lora_tree(targets, seed=20 + i))
             for i in range(3)]
    merge = tlora.materialize_lora_tree
    held, refs = [], []

    def watched(model, lora):
        held.append([r() is not None for r in refs])
        return merge(model, lora)

    monkeypatch.setattr(tlora, "materialize_lora_tree", watched)
    monkeypatch.setattr(tpipeline, "MERGED_LORA_CACHE_SIZE", 1)
    tpipe.materialize_lora = True
    try:
        tpipe.unet_lora = trees[0]
        refs = [weakref.ref(w) for w in tpipe._generation_params()[0].values()]
        tpipe.unet_lora = tlora.tune_lora_scale(trees[0], 0.5)
        tpipe._generation_params()
        tpipe.unet_lora = None
        refs = [weakref.ref(w) for w in tpipe.adapter_generation_params(trees[1])[0].values()]
        tpipe.adapter_generation_params(trees[2])
        assert len(held) == 4 and not any(any(h) for h in held), held
        assert len(tpipe._merged_cache) == 1
    finally:
        tpipe.unet_lora = None
        tpipe.invalidate_merged_cache()


def test_entry_points_default_to_cuda():
    """Without CUDA and without device="cpu" the pipeline, the train-state
    set-up and the latent cache refuse to start."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from diffusion_finetuning_tpu_torch.training.latent_cache import LatentMomentCache
    from diffusion_finetuning_tpu_torch.training.optim import ParamGroup, multi_group_optimizer
    from diffusion_finetuning_tpu_torch.training.train_step import init_train_state

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _port_pipe(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StableDiffusionPipeline(UNetConfig.tiny(), {}, VAEConfig.tiny(), {},
                                CLIPTextConfig.tiny(), {}, CLIPTokenizer.tiny())
    opt = multi_group_optimizer({"unet_lora": ParamGroup(lr=1e-4)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(opt, unet_lora={"a": {"up": torch.zeros(2, 1),
                                               "down": torch.zeros(1, 2),
                                               "scale": torch.tensor(1.0)}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LatentMomentCache(None)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke run exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "FAIL" in out.stdout


def test_chip_smoke_counts_fp32_flash_launches_in_their_own_row():
    """The fp32 flash forward (K1's fp32 kernel) has a row of its own,
    replacing the same Pallas kernel as K1: an fp32 path's launches stay off
    the bf16 K1 row, and the smoke's counters are the trainers' counters."""
    import chip_smoke
    from diffusion_finetuning_tpu_torch.training.trainer_util import kernel_launches

    row = dict(max_abs_err=1e-6, ms=1.0, plain_ms=3.0, bound_ms=0.5, bound_by="operations",
               library_ms=0.7)
    line = chip_smoke.kernels_line(
        {"flash_attention_fwd": [dict(row, shape=[1], per_step=32)],
         "flash_attention_fwd_fp32": [dict(row, shape=[1], per_step=32, ms=5.0)]},
        {"run_img2img": {"flash_attention_fwd": 960},
         "visualize_progress": {"flash_attention_fwd_fp32": 640}})
    bf16, fp32 = line["kernels"]
    assert (bf16["launches"], fp32["launches"]) == (960, 640)
    assert fp32["launches_by_path"] == {"run_img2img": 0, "visualize_progress": 640}
    assert fp32["replaces"] == bf16["replaces"] == "diffusion_finetuning_tpu/ops/flash_attention.py:87"
    assert fp32["ms"] == 160.0
    assert fp32["source"] == "diffusion_finetuning_tpu_torch/csrc/flash_attention_f32.cu"
    assert set(chip_smoke.COUNTERS) == set(kernel_launches())


def test_chip_smoke_counts_each_fp32_kernel_in_its_own_row():
    """K3's, K2's and K5's fp32 kernels have rows of their own beside their
    bf16 kernels' (the same Pallas kernel replaced, each its own source), an
    fp32 path's launches stay off the bf16 rows, each row reads its own
    wrapper counter, and the fp32 DreamBooth step counts on the fp32 rows
    alone."""
    import importlib

    import chip_smoke

    row = dict(max_abs_err=1e-6, ms=1.0, plain_ms=3.0, bound_ms=0.5, bound_by="operations",
               library_ms=0.7)
    names = ("flash_attention_bwd", "lora_dense", "conv3x3")
    results = {}
    for name in names:
        results[name] = [dict(row, shape=[1], per_step=2)]
        results[name + "_fp32"] = [dict(row, shape=[1], per_step=3, ms=4.0)]
    line = chip_smoke.kernels_line(results, {
        "trainer_dreambooth": {"flash_attention_bwd": 64, "lora_dense": 384},
        "trainer_dreambooth_fp32": {"flash_attention_bwd_fp32": 64, "lora_dense_fp32": 384,
                                    "conv3x3_fp32": 34}})
    by = {k["name"]: k for k in line["kernels"]}
    assert {n: by[n]["launches"] for n in by} == {
        "flash_attention_bwd": 64, "flash_attention_bwd_fp32": 64, "lora_dense": 384,
        "lora_dense_fp32": 384, "conv3x3": 0, "conv3x3_fp32": 34}
    for name in names:
        assert by[name + "_fp32"]["replaces"] == by[name]["replaces"]
        assert by[name + "_fp32"]["ms"] == 12.0
    assert by["flash_attention_bwd_fp32"]["source"].endswith("csrc/flash_attention_bwd_f32.cu")
    assert by["lora_dense_fp32"]["source"] == by["lora_dense"]["source"]
    assert by["conv3x3_fp32"]["source"] == by["conv3x3"]["source"]
    counters = {name: chip_smoke.COUNTERS[name] for name in by}
    assert len(set(counters.values())) == len(counters)
    for mod, attr in counters.values():
        assert isinstance(getattr(importlib.import_module(
            f"diffusion_finetuning_tpu_torch.ops.{mod}"), attr), int)
    step = chip_smoke.fp32_step_launches()
    assert {k: n for k, n in step.items() if n} == {
        "flash_attention_fwd_fp32": chip_smoke.FLASH_PER_STEP,
        "flash_attention_bwd_fp32": chip_smoke.FLASH_PER_STEP,
        "lora_dense_fp32": chip_smoke.LORA_PER_STEP + chip_smoke.TEXT_LORA_PER_ENCODE}


def test_chip_smoke_kernels_line_names_each_kernel_fully():
    """Each kernel of the kernels line carries every key, sums its times
    over one step's calls, counts its launches over the main-path runs, and
    names its source and the Pallas kernel it replaces by file and line:
    the flash forward (K1), the flash backward (K3), the LoRA dense (K2),
    the packed flash forward (K4) and the fused 3x3 conv (K5)."""
    import chip_smoke

    row = dict(max_abs_err=0.01, ms=1.0, plain_ms=3.0, bound_ms=0.5, bound_by="bytes",
               library_ms=0.7)
    line = chip_smoke.kernels_line(
        {"flash_attention_fwd": [dict(row, shape=[1], per_step=2)],
         "flash_attention_bwd": [dict(row, shape=[1], per_step=2, bound_by="operations")],
         "lora_dense": [dict(row, shape=[2], per_step=3),
                        dict(row, shape=[3], per_step=1, max_abs_err=0.03)],
         "flash_attention_fwd_packed": [dict(row, shape=[1], per_step=2),
                                        dict(row, shape=[1], per_step=0, ms=9.0)],
         "conv3x3": [dict(row, shape=[4], per_step=37, bound_by="operations")]},
        {"serving": {"flash_attention_fwd": 64, "flash_attention_bwd": 0, "lora_dense": 144},
         "train": {"flash_attention_fwd": 320, "flash_attention_bwd": 320,
                   "lora_dense": 1440},
         "img2img": {"flash_attention_fwd_packed": 1216, "conv3x3": 1406, "lora_dense": 5472}})
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    flash, bwd, lora, packed, conv = line["kernels"]
    assert [k["name"] for k in line["kernels"]] == [
        "flash_attention_fwd", "flash_attention_bwd", "lora_dense",
        "flash_attention_fwd_packed", "conv3x3"]
    for k in line["kernels"]:
        assert keys <= set(k) and k["route"] == "cuda"
        assert os.path.exists(os.path.join(ROOT, k["source"]))
        path, lineno = k["replaces"].rsplit(":", 1)
        with open(os.path.join(ROOT, path)) as f:
            assert f.readlines()[int(lineno) - 1].startswith("def _")
    assert (flash["launches"], flash["ms"], flash["plain_ms"]) == (384, 2.0, 6.0)
    assert (lora["launches"], lora["ms"], lora["max_abs_err"]) == (7056, 4.0, 0.03)
    assert (packed["launches"], packed["ms"], packed["replaces"]) == (
        1216, 2.0, "diffusion_finetuning_tpu/ops/flash_attention.py:178")
    assert (conv["launches"], conv["ms"], conv["bound_by"], conv["replaces"]) == (
        1406, 37.0, "operations", "diffusion_finetuning_tpu/ops/conv_pallas.py:72")
    assert conv["source"] == "diffusion_finetuning_tpu_torch/csrc/conv3x3.cu"
    assert bwd["replaces"] == "diffusion_finetuning_tpu/ops/flash_attention.py:285"
    assert bwd["source"] == "diffusion_finetuning_tpu_torch/csrc/flash_attention_bwd.cu"
    assert (bwd["launches"], bwd["launches_by_path"], bwd["per"], bwd["bound_by"]) == (
        320, {"serving": 0, "train": 320, "img2img": 0}, "train_step", "operations")


def test_chip_smoke_counts_the_routed_convs():
    """The smoke run's expected K5 launches come from the copied predicate:
    37 of the 44 resnet convs of an SD1.5 UNet call at 64^2 latents, at
    any batch, 2 of them in the first resnet block."""
    import chip_smoke
    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig as TUNet

    for batch in (1, 2):
        calls = chip_smoke.unet_conv3x3_calls(TUNet.sd15(), batch, 64)
        assert sum(calls.values()) == 37 and len(calls) == 10
        assert all(key[0] == batch for key in calls)
    assert chip_smoke.unet_conv3x3_calls(TUNet.sd15(), 1, 64,
                                         only="down_blocks_0_resnets_0") == {
        (1, 320, 64, 64, 320): 2}


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, imports in a fresh
    interpreter without pulling in jax or diffusion_finetuning_tpu(.*), nor
    transformers or wandb, which the card's machine lacks (``utils/eval``
    and the PTI trainer import them inside functions)."""
    code = r"""
import importlib, pkgutil, runpy, sys
import diffusion_finetuning_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
runpy.run_path("chip_smoke.py", run_name="chip_smoke")
bad = [m for m in sys.modules if m.split(".")[0] in (
    "jax", "diffusion_finetuning_tpu", "transformers", "wandb")]
assert len(names) >= 15, names
assert not bad, bad
print("ok", len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
