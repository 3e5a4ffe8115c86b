"""Shared inputs for the port's tests (tests/test_torch_port_*.py).

The JAX tiny models are initialised from a seed, their parameter trees are
turned into numpy, and the port loads them through its weight bridge; LoRA
trees and inputs are made with numpy from a seed and handed to both
packages.  Everything runs on the CPU at the tiny configs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_finetuning_tpu.models.clip_text import CLIPTextConfig, CLIPTextModel
from diffusion_finetuning_tpu.models.unet import UNet2DConditionModel, UNetConfig
from diffusion_finetuning_tpu.models.vae import AutoencoderKL, VAEConfig
from diffusion_finetuning_tpu.tree_util import tree_set

from tests.jitutil import jit_init

_MEMO = {}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_params():
    """(unet, vae, text) JAX param trees of the tiny configs, numpy leaves."""
    if "trees" not in _MEMO:
        ucfg, vcfg, tcfg = UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny()
        rng = jax.random.PRNGKey(0)
        unet = jit_init(UNet2DConditionModel(ucfg))(
            rng, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 77, ucfg.cross_attention_dim)))["params"]
        vae = jit_init(AutoencoderKL(vcfg))(rng, jnp.zeros((1, 16, 16, 3)), rng)["params"]
        text = CLIPTextModel(tcfg).init(rng, jnp.zeros((1, 77), jnp.int32))["params"]
        _MEMO["trees"] = tuple(to_numpy(t) for t in (unet, vae, text))
    return _MEMO["trees"]


def numpy_lora_tree(targets, rank=2, seed=0, scale=0.7, amp=0.3):
    """A LoRA tree with non-zero up and down for ``targets`` (numpy leaves,
    JAX paths); conv targets get torch-Conv2d-shaped pairs."""
    rng = np.random.default_rng(seed)
    tree = {}
    for t in targets:
        if t.is_conv:
            up_shape = (t.out_features, rank, 1, 1)
            down_shape = (rank, t.in_features) + tuple(t.kernel_size)
        else:
            up_shape, down_shape = (t.out_features, rank), (rank, t.in_features)
        leaf = {"up": (rng.standard_normal(up_shape) * amp).astype(np.float32),
                "down": (rng.standard_normal(down_shape) * amp).astype(np.float32),
                "scale": np.float32(scale)}
        tree = tree_set(tree, t.path, leaf)
    return tree


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def training_models():
    """JAX modules + numpy params, the port's frozen fp32 CPU modules
    holding the same weights, and numpy UNet and text LoRA trees (rank 2,
    non-zero up): the training tests' models."""
    import torch

    from diffusion_finetuning_tpu import lora as jlora
    from diffusion_finetuning_tpu.models import clip_text as jclip
    from diffusion_finetuning_tpu.models import unet as junet
    from diffusion_finetuning_tpu.models import vae as jvae
    from diffusion_finetuning_tpu_torch.models import clip_text as tclip
    from diffusion_finetuning_tpu_torch.models import unet as tunet
    from diffusion_finetuning_tpu_torch.models import vae as tvae
    from diffusion_finetuning_tpu_torch.models import weights

    ucfg, vcfg, tcfg = junet.UNetConfig.tiny(), jvae.VAEConfig.tiny(), jclip.CLIPTextConfig.tiny()
    up, vp, cp = tiny_params()
    jax_side = dict(unet=junet.UNet2DConditionModel(ucfg), vae=jvae.AutoencoderKL(vcfg),
                    text_encoder=jclip.CLIPTextModel(tcfg), unet_params=to_jax(up),
                    vae_params=to_jax(vp), text_params=to_jax(cp))
    port = dict(
        unet=weights.load_module(tunet.UNet2DConditionModel, tunet.UNetConfig.tiny(),
                                 weights.unet_state_dict(up, ucfg), torch.float32, "cpu"),
        vae=weights.load_module(tvae.AutoencoderKL, tvae.VAEConfig.tiny(),
                                weights.vae_state_dict(vp, vcfg), torch.float32, "cpu"),
        text_encoder=weights.load_module(tclip.CLIPTextModel, tclip.CLIPTextConfig.tiny(),
                                         weights.text_state_dict(cp, tcfg), torch.float32,
                                         "cpu"))
    unet_targets = jlora.filter_targets(junet.unet_lora_targets(ucfg),
                                        jlora.DEFAULT_TARGET_REPLACE)
    trees = dict(unet=numpy_lora_tree(unet_targets, rank=2, seed=0),
                 text=numpy_lora_tree(jclip.text_encoder_lora_targets(tcfg), rank=2, seed=1))
    return jax_side, port, trees


# ---------------------------------------------------------------------------
# the trainer tests (test_torch_port_trainers.py, test_torch_port_dreambooth.py)
# ---------------------------------------------------------------------------

TRAINER_LATENT = (8, 8, 4)  # the tiny VAE's latent grid for 16x16 pixels
# parameters within 2% of their group's LR for each update taken: AdamW's
# g / (|g| + eps) turns the gradients' relative differences of ~1e-5 into up
# to ~1e-3 of an update where |g| is within a few orders of eps, and a
# gradient element that cancels to near zero can differ more (the PTI
# UNet LoRA's worst element after two updates: 1.2% of them)
TRAINER_ATOL = 2e-2


def trainer_dirs(tmp_path_factory):
    """A diffusers directory of the port's tiny pipe (torch's default
    initialisation under a seed, fp32: no JAX init to trace and compile),
    2 instance and 2 class images: the trainer tests' inputs."""
    import torch
    from PIL import Image

    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu_torch.models import clip_text as tclip
    from diffusion_finetuning_tpu_torch.models import hf_export
    from diffusion_finetuning_tpu_torch.models import unet as tunet
    from diffusion_finetuning_tpu_torch.models import vae as tvae
    from diffusion_finetuning_tpu_torch.models.schedulers import SchedulerConfig
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline

    root = tmp_path_factory.mktemp("port_trainers")
    model = str(root / "model")
    cfgs = (tunet.UNetConfig.tiny(), tvae.VAEConfig.tiny(), tclip.CLIPTextConfig.tiny())
    sds = []
    for i, (cls, cfg) in enumerate(zip((tunet.UNet2DConditionModel, tvae.AutoencoderKL,
                                        tclip.CLIPTextModel), cfgs)):
        torch.manual_seed(i)
        sds.append(cls(cfg).state_dict())
    pipe = StableDiffusionPipeline(cfgs[0], sds[0], cfgs[1], sds[1], cfgs[2], sds[2],
                                   CLIPTokenizer.tiny(["photo", "of", "sks"]), SchedulerConfig(),
                                   dtype=torch.float32, device="cpu")
    hf_export.save_pretrained(pipe, model)
    rng = np.random.default_rng(0)
    for sub, name in (("inst", "a photo of sks_{}.png"), ("cls", "class_{}.png")):
        (root / sub).mkdir()
        for i in range(2):
            arr = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / sub / name.format(i))
    return {"root": root, "model": model, "inst": str(root / "inst"),
            "cls": str(root / "cls")}


def trainer_draws(key, batch, t_max):
    """loss_step's draws for ``key``, as the JAX function makes them."""
    r_sample, r_noise, r_t = jax.random.split(key, 3)
    shape = (batch,) + TRAINER_LATENT
    return {"sample": np.array(jax.random.normal(r_sample, shape, jnp.float32)),
            "noise": np.array(jax.random.normal(r_noise, shape, jnp.float32)),
            "timesteps": np.array(jax.random.randint(r_t, (batch,), 0, t_max))}


def step_keys(rng, n):
    """The per-step keys of JAX's ``FusedDispatcher.drive`` at spd 1."""
    keys = []
    for _ in range(n):
        rng, key = jax.random.split(rng)
        keys.append(key)
    return keys


def recording_dispatcher(losses):
    """JAX's FusedDispatcher, recording each dispatch's losses."""

    from diffusion_finetuning_tpu.training import train_step as jtrain

    class Recording(jtrain.FusedDispatcher):
        def drive(self, *args, **kwargs):
            for out in super().drive(*args, **kwargs):
                losses.append(np.asarray(out[1]))
                yield out

    return Recording


def given_draws_dispatcher(phase_draws):
    """The port's FusedDispatcher, each drive (one per phase) handed the
    next phase's draws."""
    from diffusion_finetuning_tpu_torch.training import train_step as ttrain

    phases = iter(phase_draws)

    class Given(ttrain.FusedDispatcher):
        def drive(self, state, rng, take_group, total_steps, start_step=0, draws=None):
            yield from super().drive(state, rng, take_group, total_steps, start_step,
                                     draws=next(phases))

    return Given


def flat_lora(tree, targets):
    """A LoRA tree of either package as its flat fp32 numpy list."""
    import torch

    from diffusion_finetuning_tpu import lora as jlora

    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        return node.detach().numpy() if isinstance(node, torch.Tensor) else node

    return [np.asarray(a, np.float32) for a in jlora.lora_tree_to_flat(host(tree), targets)]


def assert_params_close(got, want, lr, updates):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=TRAINER_ATOL * lr * updates)


def assert_same_safetensors(got_path, want_path, lr, updates):
    """Two safetensors files: the same tensor names and metadata, the values
    within :func:`assert_params_close`."""
    from diffusion_finetuning_tpu.io import safetensors_io

    got, gmeta = safetensors_io.read_safetensors(got_path)
    want, wmeta = safetensors_io.read_safetensors(want_path)
    assert sorted(got) == sorted(want) and gmeta == wmeta
    assert_params_close([np.asarray(got[k], np.float32) for k in sorted(want)],
                        [np.asarray(want[k], np.float32) for k in sorted(want)], lr, updates)


@pytest.fixture
def small_images(monkeypatch):
    """The port's requests at 16^2 unless a size is given: ``evaluate_pipe``,
    ``visualize_progress`` and the merge and GIF scripts ask for the pipe's
    default 512^2, where the tiny VAE's mid-block attention alone would
    hold 256^2 x 256^2 scores on the CPU."""
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline

    real = StableDiffusionPipeline.__call__
    monkeypatch.setattr(StableDiffusionPipeline, "__call__",
                        lambda self, *a, **kw: real(self, *a, **{"height": 16, "width": 16,
                                                                 **kw}))
