"""The port's SD 2.x path against the JAX package's, on the CPU.

A tiny SD2-style configuration: the UNet of ``tests/test_sd2_config.py``
(linear ``proj_in``/``proj_out``, per-block head counts (2, 4, 4, 4)), the
tiny CLIP text encoder with OpenCLIP's ``gelu``, the tiny VAE, and a
v-prediction scheduler.  The weights are torch's initialisation under a
seed, read into JAX's param trees by JAX's ``hf_loading``; the port loads
those trees through its weight bridge, or reads the diffusers directory
JAX's ``hf_export.save_pretrained`` wrote; LoRA trees (non-zero
up) and inputs are made with numpy from a seed; JAX's random draws are
handed to the port.

Tolerances, those of the matching SD1.5 port tests: the UNet and the text
encoder 1e-4 (``test_torch_port_models.py``); txt2img images within 1/255
(``test_torch_port_pipeline.py``); the train step's loss 1e-5 relative and
its LoRA gradient 1e-4 relative L2 (``test_torch_port_training.py``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu import lora as jlora
from diffusion_finetuning_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
from diffusion_finetuning_tpu.models import clip_text as jclip
from diffusion_finetuning_tpu.models import hf_export as jexport
from diffusion_finetuning_tpu.models import hf_loading as jhf
from diffusion_finetuning_tpu.models import schedulers as jsched
from diffusion_finetuning_tpu.models import unet as junet
from diffusion_finetuning_tpu.models import vae as jvae
from diffusion_finetuning_tpu.pipelines.pipeline import StableDiffusionPipeline as JaxPipe
from diffusion_finetuning_tpu.training import loss as jloss

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
from diffusion_finetuning_tpu_torch.models import clip_text as tclip
from diffusion_finetuning_tpu_torch.models import schedulers as tsched
from diffusion_finetuning_tpu_torch.models import unet as tunet
from diffusion_finetuning_tpu_torch.models import vae as tvae
from diffusion_finetuning_tpu_torch.models import weights
from diffusion_finetuning_tpu_torch.ops import _grid
from diffusion_finetuning_tpu_torch.ops import flash_attention as tfa
from diffusion_finetuning_tpu_torch.ops import lora_matmul as tlm
from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline
from diffusion_finetuning_tpu_torch.training import loss as tloss
from diffusion_finetuning_tpu_torch.training import optim as topt
from diffusion_finetuning_tpu_torch.training import train_step as ttrain

from tests import test_torch_port_ops as ops_tests
from tests.jitutil import jit_apply
from tests.torch_port_fixtures import numpy_lora_tree, to_jax, to_numpy

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-4
GRAD_REL_L2 = 1e-4
WORDS = ["photo", "of", "sks"]
PROMPTS = ["a photo of sks", "photo"]
KW = dict(height=16, width=16, num_inference_steps=3, guidance_scale=7.5, output_type="np")

UNET = dict(sample_size=8, block_out_channels=(8, 16, 16, 16), layers_per_block=1,
            cross_attention_dim=32, attention_head_dim=(2, 4, 4, 4), norm_num_groups=4,
            use_linear_projection=True)
TEXT = dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=77, hidden_act="gelu")
V_PRED = dict(prediction_type="v_prediction")


@pytest.fixture(scope="module")
def sd2():
    """The tiny SD2-style models' weights (torch's initialisation under a
    seed, read into JAX param trees by JAX's ``hf_loading``: no JAX init to
    trace and compile), the JAX pipeline of them, its images of PROMPTS
    from given latents with a dynamic UNet LoRA, and that LoRA (numpy)."""
    ucfg, vcfg, tcfg = junet.UNetConfig(**UNET), jvae.VAEConfig.tiny(), jclip.CLIPTextConfig(**TEXT)
    sds = []
    for i, (cls, cfg) in enumerate(((tunet.UNet2DConditionModel, tunet.UNetConfig(**UNET)),
                                    (tvae.AutoencoderKL, tvae.VAEConfig.tiny()),
                                    (tclip.CLIPTextModel, tclip.CLIPTextConfig(**TEXT)))):
        torch.manual_seed(i)
        sds.append({k: v.numpy() for k, v in cls(cfg).state_dict().items()})
    params = tuple(to_numpy(p) for p in (
        jhf.unet_params_from_hf_state_dict(sds[0], ucfg),
        jhf.vae_params_from_hf_state_dict(sds[1], vcfg),
        jclip.params_from_hf_state_dict(sds[2], tcfg)))
    jpipe = JaxPipe(ucfg, to_jax(params[0]), vcfg, to_jax(params[1]), tcfg, to_jax(params[2]),
                    JaxTokenizer.tiny(WORDS), jsched.SchedulerConfig(**V_PRED))
    lora_np = numpy_lora_tree(jpipe.lora_targets("unet", jlora.DEFAULT_TARGET_REPLACE),
                              seed=11, amp=0.5)
    jpipe.unet_lora, jpipe.materialize_lora = to_jax(lora_np), False
    images = np.asarray(jpipe(PROMPTS, latents=jnp.asarray(_latents()), **KW))
    return {"configs": (ucfg, vcfg, tcfg), "params": params, "pipe": jpipe, "images": images,
            "lora": lora_np}


def _latents():
    return np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32)


def _port_modules(sd2):
    (ucfg, vcfg, tcfg), (up, vp, cp) = sd2["configs"], sd2["params"]
    return (
        weights.load_module(tunet.UNet2DConditionModel, tunet.UNetConfig(**UNET),
                            weights.unet_state_dict(up, ucfg), torch.float32, "cpu"),
        weights.load_module(tvae.AutoencoderKL, tvae.VAEConfig.tiny(),
                            weights.vae_state_dict(vp, vcfg), torch.float32, "cpu"),
        weights.load_module(tclip.CLIPTextModel, tclip.CLIPTextConfig(**TEXT),
                            weights.text_state_dict(cp, tcfg), torch.float32, "cpu"))


def test_sd2_unet_with_lora_matches_jax(sd2):
    """Linear projections and per-block heads, with a non-zero LoRA on the
    default targets, which on SD2 include proj_in and proj_out's blocks'
    attention and GEGLU layers."""
    ucfg, up = sd2["configs"][0], sd2["params"][0]
    unet = _port_modules(sd2)[0]
    proj = unet.get_submodule("down_blocks.0.attentions.0.proj_in")
    assert proj.weight.ndim == 2
    assert [b.attentions[0].transformer_blocks[0].attn1.heads for b in unet.down_blocks
            if b.attentions] == [2, 4, 4]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([981, 1], np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    lora_np = sd2["lora"]
    want = jit_apply(junet.UNet2DConditionModel(ucfg))(
        {"params": to_jax(up), "lora": to_jax(lora_np)}, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(ctx))
    args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t).long(),
            torch.from_numpy(ctx))
    with torch.no_grad():
        base = unet(*args)
        with tlora.attached(unet, weights.lora_tree_to_torch(lora_np)):
            got = unet(*args)
    assert float((got - base).abs().max()) > 1e-2  # the LoRA moves the output
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_sd2_text_encoder_matches_jax(sd2):
    """OpenCLIP's gelu (not quick_gelu), with a non-zero text LoRA."""
    tcfg, cp = sd2["configs"][2], sd2["params"][2]
    text = _port_modules(sd2)[2]
    assert text.config.hidden_act == "gelu"
    ids = JaxTokenizer.tiny(WORDS)(PROMPTS, padding="max_length", max_length=77,
                                   return_tensors="np")["input_ids"]
    lora_np = numpy_lora_tree(jclip.text_encoder_lora_targets(tcfg), seed=7)
    want = jit_apply(jclip.CLIPTextModel(tcfg))(
        {"params": to_jax(cp), "lora": to_jax(lora_np)}, jnp.asarray(ids))
    with torch.no_grad(), tlora.attached(text, weights.lora_tree_to_torch(lora_np)):
        got = text(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("source", ["weights", "jax_directory"])
def test_sd2_txt2img_matches_jax(sd2, source, tmp_path):
    """3 DDIM v-prediction steps with CFG and a dynamic UNet LoRA from given
    latents: the port's pipe built from the weight bridge, or read by
    ``from_pretrained`` from the directory JAX's ``hf_export`` wrote, every
    SD2 field of which it must read back."""
    if source == "weights":
        unet, vae, text = (m.state_dict() for m in _port_modules(sd2))
        pipe = StableDiffusionPipeline(
            tunet.UNetConfig(**UNET), unet, tvae.VAEConfig.tiny(), vae,
            tclip.CLIPTextConfig(**TEXT), text, CLIPTokenizer.tiny(WORDS),
            tsched.SchedulerConfig(**V_PRED), device="cpu")
    else:
        jexport.save_pretrained(sd2["pipe"], str(tmp_path))
        pipe = StableDiffusionPipeline.from_pretrained(str(tmp_path), device="cpu")
        assert pipe.unet_config == tunet.UNetConfig(**UNET)
        assert pipe.text_config == tclip.CLIPTextConfig(**TEXT)
        assert pipe.scheduler_config.prediction_type == "v_prediction"
        assert os.path.exists(tmp_path / "unet" / "config.json")
    pipe.unet_lora = weights.lora_tree_to_torch(sd2["lora"])
    pipe.materialize_lora = False
    got = pipe(PROMPTS, latents=_latents(), **KW)
    want = sd2["images"]
    assert got.shape == want.shape == (2, 16, 16, 3)
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
    # v-prediction is on the path: read as epsilon the same model differs
    pipe.scheduler_config = dataclasses.replace(pipe.scheduler_config,
                                                prediction_type="epsilon")
    assert np.abs(pipe(PROMPTS, latents=_latents(), **KW) - want).max() > 2.0 / 255


def test_sd2_train_step_v_target_matches_jax(sd2):
    """One ``build_train_step`` step with a UNet LoRA under the v target,
    JAX's draws handed in: its loss and raw LoRA gradient against JAX's
    ``loss_step`` and its gradient."""
    (ucfg, vcfg, tcfg), (up, vp, cp) = sd2["configs"], sd2["params"]
    unet, vae, text = _port_modules(sd2)
    lora_np = sd2["lora"]
    rng = np.random.default_rng(2)
    batch = {"pixel_values": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
             "input_ids": rng.integers(0, 1000, (2, 77)).astype(np.int32)}
    key = jax.random.PRNGKey(3)
    jscheduler = jsched.DDPMScheduler(jsched.SchedulerConfig(**V_PRED))

    def jfn(unet_lora):
        return jloss.loss_step(
            key, {k: jnp.asarray(v) for k, v in batch.items()},
            unet=junet.UNet2DConditionModel(ucfg), unet_params=to_jax(up),
            text_encoder=jclip.CLIPTextModel(tcfg), text_params=to_jax(cp),
            vae=jvae.AutoencoderKL(vcfg), vae_params=to_jax(vp), scheduler=jscheduler,
            unet_lora=unet_lora)

    want_loss, want_grad = jax.jit(jax.value_and_grad(jfn))(to_jax(lora_np))

    r_sample, r_noise, r_t = jax.random.split(key, 3)
    draws = {"sample": np.array(jax.random.normal(r_sample, (2, 8, 8, 4), jnp.float32)),
             "noise": np.array(jax.random.normal(r_noise, (2, 8, 8, 4), jnp.float32)),
             "timesteps": np.array(jax.random.randint(r_t, (2,), 0, 1000))}
    opt = topt.multi_group_optimizer({"unet_lora": topt.ParamGroup(lr=1e-3)})
    seen = []
    real = opt.step
    opt.step = lambda st: (seen.append([p.grad.clone().numpy().ravel() for p in st.params()]),
                           real(st))[1]
    step = ttrain.build_train_step(
        unet=unet, text_encoder=text, vae=vae,
        scheduler=tsched.DDPMScheduler(tsched.SchedulerConfig(**V_PRED)), optimizer=opt,
        partition=ttrain.TrainablePartition(unet_lora=True))
    state = ttrain.init_train_state(opt, unet_lora=weights.lora_tree_to_torch(lora_np),
                                    device="cpu")
    state, metrics = step(state, batch, draws=draws)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-5)
    got = np.concatenate(seen[0])
    want = np.concatenate(_flat(to_numpy(want_grad)))
    assert got.shape == want.shape
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) <= GRAD_REL_L2
    # the epsilon target gives another loss on the same draws
    with torch.no_grad():
        eps_loss = tloss.loss_step(batch, unet=unet, text_encoder=text, vae=vae,
                                   scheduler=tsched.DDPMScheduler(),
                                   unet_lora=weights.lora_tree_to_torch(lora_np), draws=draws)
    assert abs(float(eps_loss) - float(want_loss)) > 1e-3 * abs(float(want_loss))


def _flat(tree):
    """Leaves in sorted-key order without ``scale``: the order of
    ``optim.trainable_tensors``."""
    if not isinstance(tree, dict):
        return [np.asarray(tree, np.float32).ravel()]
    return [a for k in sorted(tree) if k != "scale" for a in _flat(tree[k])]


# SD 2.1 at 768^2: (heads, tokens, channels) of each UNet level's
# transformer blocks, head dim 64 everywhere, cross-attention over 77
# OpenCLIP tokens of width 1024
SD21_LEVELS = [(5, 9216, 320), (10, 2304, 640), (20, 576, 1280), (20, 144, 1280)]


@pytest.mark.parametrize("batch", [2, 1], ids=["serve", "train"])
@pytest.mark.parametrize("heads,tokens,skv", [(h, s, kv) for h, s, _ in SD21_LEVELS
                                               for kv in (s, 77)])
def test_sd21_flash_grid_plans(heads, tokens, skv, batch):
    """K1's q tile and K3's q splits at every SD 2.1 attention call (d = 64,
    Sq up to 9216, 2.25 times SD1.5's longest), CFG serving and training:
    the invariants ``test_torch_port_ops.py`` holds at the SD1.5 shapes;
    d = 64 is the widest head of K3's 64-row q tile and of the fp32
    kernels' unpadded head."""
    ops_tests.check_flash_plans(tokens, skv, 64, batch * heads)
    assert tfa.bwd_q_rows(64) == 64 and tfa.f32_head_pad(64) == 64
    assert tfa.bwd_q_rows_f32(64) == 32


@pytest.mark.parametrize("batch", [2, 1], ids=["serve", "train"])
def test_sd21_lora_plans(batch):
    """K2's bf16 and fp32 grids at every LoRA'd projection of SD 2.1 (M up
    to 18,432, the cross-attention K/V at K = 1024): the bf16 plan's
    invariants of ``test_torch_port_ops.py``; the fp32 plan one of the
    tiles no taller than M, covering M and N, the largest whose grid fills
    half a wave, else 64 x 64 with the 32-deep k-loop split into runs of at
    least 4 steps, only where that grid is under half a wave."""
    for heads, tokens, c in SD21_LEVELS:
        m = batch * tokens
        for mm, k, n in ((m, c, c), (77 * batch, 1024, c), (m, c, 8 * c)):
            ops_tests.check_lora_plan(mm, k, n)
            bm, bn, splits = tlm.plan_f32(mm, n, k)
            assert (bm, bn) in tlm.TILES and bm <= _grid.cdiv(mm, 64) * 64
            tiles = _grid.cdiv(mm, bm) * _grid.cdiv(n, bn)
            larger = [(tm, tn) for tm, tn in tlm.TILES[:tlm.TILES.index((bm, bn))]
                      if tm <= _grid.cdiv(mm, 64) * 64]
            assert all(_grid.cdiv(mm, tm) * _grid.cdiv(n, tn) < 66 for tm, tn in larger)
            runs = _grid.split_steps(_grid.cdiv(k, tlm.K_STEP_F32), splits)
            assert splits == 1 or (tiles < 66 and all(b - a >= 4 for a, b in runs))
    assert tlm.plan(18432, 320, 320) == (128, 128, 1)
    assert tlm.plan(154, 1280, 1024) == (64, 64, 2)
