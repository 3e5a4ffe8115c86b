"""Write a pipeline as a diffusers model directory (port of the JAX
package's ``models/hf_export.py`` ``save_pretrained``, :204-333).

The modules' state dicts already carry the diffusers names, so the export is
their weights, in safetensors, beside the configs, the scheduler config and
the tokenizer's ``vocab.json`` and ``merges.txt``; or, with ``source_dir``,
beside the non-weight files copied from another directory.  An SDXL pipe
adds its second tower and tokenizer (``text_encoder_2``, ``tokenizer_2``)
and the UNet's and VAE's SDXL keys.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Optional

import torch

from ..io import safetensors_io
from .clip_text import TOKEN_EMBEDDING


def save_pretrained(pipe, out_dir: str, source_dir: Optional[str] = None,
                    dtype: torch.dtype = torch.float32) -> None:
    """Write ``pipe``'s UNet, VAE and text encoder (its installed text
    overrides, a TI-grown token table, included; no LoRA) in ``dtype`` (the
    JAX function's ``as_half=True`` is ``dtype=torch.float16``); configs,
    tokenizer and scheduler files are copied from ``source_dir`` when
    given, else written from the pipe's own."""

    def write(subdir: str, filename: str, sd: Dict[str, torch.Tensor]):
        d = os.path.join(out_dir, subdir)
        os.makedirs(d, exist_ok=True)
        safetensors_io.write_safetensors({k: v.to(dtype) for k, v in sd.items()},
                                         os.path.join(d, filename))

    text_sd = {**pipe.text_encoder.state_dict(), **pipe.text_params}
    write("unet", "diffusion_pytorch_model.safetensors", pipe.unet.state_dict())
    write("vae", "diffusion_pytorch_model.safetensors", pipe.vae.state_dict())
    write("text_encoder", "model.safetensors", text_sd)
    tower_2 = getattr(pipe, "text_encoder_2", None)
    if tower_2 is not None:
        write("text_encoder_2", "model.safetensors", tower_2.state_dict())

    if source_dir is None:
        _write_configs(pipe, out_dir, text_vocab=text_sd[TOKEN_EMBEDDING].shape[0])
        _write_tokenizer_files(pipe.tokenizer, os.path.join(out_dir, "tokenizer"))
        if tower_2 is not None:
            _write_tokenizer_files(pipe.tokenizer_2, os.path.join(out_dir, "tokenizer_2"))
        return
    for sub in ("unet", "vae", "text_encoder", "scheduler", "tokenizer", "text_encoder_2",
                "tokenizer_2"):
        src = os.path.join(source_dir, sub)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(out_dir, sub)
        os.makedirs(dst, exist_ok=True)
        for f in os.listdir(src):
            if f.endswith((".json", ".txt")):
                shutil.copy(os.path.join(src, f), os.path.join(dst, f))
    idx = os.path.join(source_dir, "model_index.json")
    if os.path.exists(idx):
        # components not rewritten here (safety_checker, ...) are copied
        # whole; entries whose directory is missing are dropped, or
        # diffusers refuses the export
        with open(idx) as f:
            index = json.load(f)
        for name in list(index):
            if name.startswith("_") or not isinstance(index[name], list):
                continue
            if os.path.isdir(os.path.join(out_dir, name)):
                continue
            src = os.path.join(source_dir, name)
            if os.path.isdir(src):
                shutil.copytree(src, os.path.join(out_dir, name), dirs_exist_ok=True)
            else:
                index[name] = [None, None]
        with open(os.path.join(out_dir, "model_index.json"), "w") as f:
            json.dump(index, f, indent=2)


def _write_tokenizer_files(tok, d: str) -> None:
    """vocab.json and merges.txt of the in-memory tokenizer (JAX :269)."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(tok.encoder, f)
    merges = [m for m, _ in sorted(tok.bpe_ranks.items(), key=lambda kv: kv[1])]
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
        f.write("\n".join(" ".join(m) for m in merges))
    if tok.pad_token != tok.eos_token:
        with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
            json.dump({"pad_token": tok.pad_token}, f)


def _write_configs(pipe, out_dir: str, text_vocab: int) -> None:
    """The model configs and the scheduler config (JAX :281)."""
    u, v = pipe.unet_config, pipe.vae_config
    t = dataclasses.replace(pipe.text_config, vocab_size=text_vocab)
    sdxl = {}
    if u.text_time or u.transformer_layers_per_block != 1:
        depth = u.transformer_layers_per_block
        sdxl = {"transformer_layers_per_block": list(depth) if isinstance(depth, tuple)
                else depth,
                "addition_embed_type": u.addition_embed_type,
                "addition_time_embed_dim": u.addition_time_embed_dim,
                "projection_class_embeddings_input_dim":
                    u.projection_class_embeddings_input_dim}

    def dump(subdir, name, obj):
        d = os.path.join(out_dir, subdir)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, name), "w") as f:
            json.dump(obj, f, indent=2)

    dump("unet", "config.json", {
        "_class_name": "UNet2DConditionModel",
        "sample_size": u.sample_size, "in_channels": u.in_channels,
        "out_channels": u.out_channels,
        "block_out_channels": list(u.block_out_channels),
        "layers_per_block": u.layers_per_block,
        "cross_attention_dim": u.cross_attention_dim,
        "attention_head_dim": (list(u.attention_head_dim)
                               if isinstance(u.attention_head_dim, (tuple, list))
                               else u.attention_head_dim),
        "down_block_types": list(u.down_block_types),
        "up_block_types": list(u.up_block_types),
        "norm_num_groups": u.norm_num_groups,
        "use_linear_projection": u.use_linear_projection,
        "flip_sin_to_cos": u.flip_sin_to_cos, "freq_shift": u.freq_shift, **sdxl,
    })
    dump("vae", "config.json", {
        "_class_name": "AutoencoderKL",
        "in_channels": v.in_channels, "out_channels": v.out_channels,
        "latent_channels": v.latent_channels,
        "block_out_channels": list(v.block_out_channels),
        "layers_per_block": v.layers_per_block,
        "norm_num_groups": v.norm_num_groups, "sample_size": v.sample_size,
        "scaling_factor": v.scaling_factor,
    })
    dump("text_encoder", "config.json", _text_config(t))
    if getattr(pipe, "text_encoder_2", None) is not None:
        dump("text_encoder_2", "config.json", _text_config(pipe.text_config_2))
    sc = pipe.scheduler_config
    dump("scheduler", "scheduler_config.json", {
        "_class_name": "DDPMScheduler",
        "num_train_timesteps": sc.num_train_timesteps,
        "beta_start": sc.beta_start, "beta_end": sc.beta_end,
        "beta_schedule": sc.beta_schedule,
        "prediction_type": sc.prediction_type,
        "steps_offset": sc.steps_offset,
        "set_alpha_to_one": sc.set_alpha_to_one,
        **({"timestep_spacing": sc.timestep_spacing} if hasattr(sc, "timestep_spacing")
           else {}),
    })


def _text_config(t) -> dict:
    out = {"architectures": ["CLIPTextModel" if t.projection_dim is None
                             else "CLIPTextModelWithProjection"],
           "vocab_size": t.vocab_size,
           "hidden_size": t.hidden_size, "intermediate_size": t.intermediate_size,
           "num_hidden_layers": t.num_hidden_layers,
           "num_attention_heads": t.num_attention_heads,
           "max_position_embeddings": t.max_position_embeddings,
           "hidden_act": t.hidden_act}
    if t.projection_dim is not None:
        out["projection_dim"] = t.projection_dim
    return out
