"""Read a local diffusers model directory (port of the JAX package's
``models/hf_loading.py``).

The port's modules carry the diffusers and transformers state-dict names
(``models/weights.py``), so a directory's weights load into them as they
are: no transposes and no renaming, unlike the JAX loader's mapping onto
Flax trees.  What remains is reading: ``.safetensors`` or torch ``.bin``
files, whole or sharded (:37-70), the three config readers (:274-316), and
two spellings the JAX loader also accepts: the VAE attention under the
newer ``to_q/to_k/to_v/to_out.0`` names (or as 1x1 convs), and a text
encoder saved without its ``text_model.`` prefix.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict

import torch

from ..io import safetensors_io
from .clip_text import CLIPTextConfig
from .unet import UNetConfig
from .vae import VAEConfig


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """One weights file (.safetensors or torch .bin) as host tensors."""
    if path.endswith(".safetensors"):
        return safetensors_io.read_safetensors(path)[0]
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def load_model_dir_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every weight shard of a diffusers model subdirectory."""
    for name in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                 "model.safetensors", "pytorch_model.bin"):
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            return _load_state_dict(p)
    sd: Dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(model_dir)):
        if re.match(r".*-\d{5}-of-\d{5}\.(safetensors|bin)$", name):
            sd.update(_load_state_dict(os.path.join(model_dir, name)))
    if not sd:
        raise FileNotFoundError(f"no weights found in {model_dir}")
    return sd


_VAE_ATTN_NEW = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def vae_state_dict_from_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The VAE's mid-block attention under the port's (older diffusers)
    names ``query/key/value/proj_attn``, 1x1 conv weights as linear ones
    (JAX ``map_attn``, :226-245)."""
    out = {}
    for k, v in sd.items():
        m = re.match(r"(.*\.attentions\.\d+)\.(to_q|to_k|to_v|to_out\.0)\.(weight|bias)$", k)
        if m:
            k = f"{m.group(1)}.{_VAE_ATTN_NEW[m.group(2)]}.{m.group(3)}"
        if re.search(r"\.attentions\.\d+\.(query|key|value|proj_attn)\.weight$", k) \
                and v.ndim == 4:
            v = v[:, :, 0, 0]
        out[k] = v
    return out


def text_state_dict_from_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """transformers CLIPTextModel keys, with the ``text_model.`` prefix
    added where the file has none (JAX ``params_from_hf_state_dict``)."""
    if any(k.startswith("text_model.") for k in sd):
        return dict(sd)
    return {"text_model." + k: v for k, v in sd.items()}


def module_state_dict(module_cls, config, sd: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` that ``module_cls(config)`` holds.  Extra
    entries (buffers such as CLIP's ``position_ids``) are dropped, as the
    JAX loader reads only what it maps; a missing one raises at the strict
    load."""
    with torch.device("meta"):
        keys = module_cls(config).state_dict().keys()
    return {k: sd[k] for k in keys if k in sd}


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def unet_config_from_hf(config: dict) -> UNetConfig:
    head = config.get("attention_head_dim", 8)
    return UNetConfig(
        sample_size=config.get("sample_size", 64),
        in_channels=config.get("in_channels", 4),
        out_channels=config.get("out_channels", 4),
        block_out_channels=tuple(config.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=config.get("layers_per_block", 2),
        cross_attention_dim=config.get("cross_attention_dim", 768),
        attention_head_dim=tuple(head) if isinstance(head, list) else head,
        down_block_types=tuple(config.get("down_block_types", UNetConfig().down_block_types)),
        up_block_types=tuple(config.get("up_block_types", UNetConfig().up_block_types)),
        norm_num_groups=config.get("norm_num_groups", 32),
        use_linear_projection=config.get("use_linear_projection", False),
        flip_sin_to_cos=config.get("flip_sin_to_cos", True),
        freq_shift=config.get("freq_shift", 0),
        transformer_layers_per_block=_int_or_tuple(config.get("transformer_layers_per_block", 1)),
        addition_embed_type=config.get("addition_embed_type"),
        addition_time_embed_dim=config.get("addition_time_embed_dim") or 256,
        projection_class_embeddings_input_dim=(
            config.get("projection_class_embeddings_input_dim") or 2816),
    )


def _int_or_tuple(v):
    return tuple(v) if isinstance(v, list) else v


def vae_config_from_hf(config: dict) -> VAEConfig:
    return VAEConfig(
        in_channels=config.get("in_channels", 3),
        out_channels=config.get("out_channels", 3),
        latent_channels=config.get("latent_channels", 4),
        block_out_channels=tuple(config.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=config.get("layers_per_block", 2),
        norm_num_groups=config.get("norm_num_groups", 32),
        sample_size=config.get("sample_size", 512),
        scaling_factor=config.get("scaling_factor", 0.18215),
    )


def clip_config_from_hf(config: dict) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=config.get("vocab_size", 49408),
        hidden_size=config.get("hidden_size", 768),
        intermediate_size=config.get("intermediate_size", 3072),
        num_hidden_layers=config.get("num_hidden_layers", 12),
        num_attention_heads=config.get("num_attention_heads", 12),
        max_position_embeddings=config.get("max_position_embeddings", 77),
        hidden_act=config.get("hidden_act", "quick_gelu"),
        layer_norm_eps=config.get("layer_norm_eps", 1e-5),
        # transformers' CLIPTextModelWithProjection (SDXL's text_encoder_2)
        projection_dim=(config.get("projection_dim", 768)
                        if "CLIPTextModelWithProjection" in config.get("architectures", [])
                        else None),
    )


def load_pipeline_components(model_dir: str) -> Dict[str, Any]:
    """The UNet, VAE and text-encoder configs and state dicts (host
    tensors, as stored) of a local diffusers directory, and its scheduler
    config as a dict ({} when absent); the tokenizer is read by
    ``data.tokenizer``.  An SDXL directory's second tower
    (``text_encoder_2``) comes as ``text_2_config`` and
    ``text_2_state_dict``."""
    from .clip_text import CLIPTextModel
    from .unet import UNet2DConditionModel
    from .vae import AutoencoderKL

    out: Dict[str, Any] = {}
    parts = [("unet", "unet", unet_config_from_hf, UNet2DConditionModel, dict),
             ("vae", "vae", vae_config_from_hf, AutoencoderKL, vae_state_dict_from_hf),
             ("text", "text_encoder", clip_config_from_hf, CLIPTextModel,
              text_state_dict_from_hf)]
    if os.path.isdir(os.path.join(model_dir, "text_encoder_2")):
        parts.append(("text_2", "text_encoder_2", clip_config_from_hf, CLIPTextModel,
                      text_state_dict_from_hf))
    for name, sub, read_cfg, cls, fix in parts:
        d = os.path.join(model_dir, sub)
        cfg = read_cfg(read_json(os.path.join(d, "config.json")))
        out[f"{name}_config"] = cfg
        out[f"{name}_state_dict"] = module_state_dict(cls, cfg,
                                                      fix(load_model_dir_state_dict(d)))
    sched = os.path.join(model_dir, "scheduler", "scheduler_config.json")
    out["scheduler_config"] = read_json(sched) if os.path.exists(sched) else {}
    return out
