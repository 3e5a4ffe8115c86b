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
