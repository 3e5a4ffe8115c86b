"""Diffusers directory -> original Stable Diffusion ``.ckpt`` (port of the
JAX package's ``to_ckpt_v2.py``, reference to_ckpt_v2.py:91-232).

The UNet's keys go under ``model.diffusion_model.*`` in the LDM layout
(sequential input/middle/output blocks, resnet sublayers as
``in_layers/out_layers``), the VAE's under ``first_stage_model.*`` (decoder
up-blocks reversed, the mid-attention's 2-D projections reshaped to 1x1
convs), the text encoder's unchanged under
``cond_stage_model.transformer.*``: regex rules applied per key, as in JAX
(:36-156).  Weights are read with ``models/hf_loading._load_state_dict``
(safetensors or torch ``.bin``) and written with ``torch.save`` as
``{"state_dict": ...}``, each tensor with its own storage.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Tuple

import torch

from .models.hf_loading import _load_state_dict

_RuleList = List[Tuple[re.Pattern, Callable]]


def _rules(pairs) -> _RuleList:
    return [(re.compile(pat), fn) for pat, fn in pairs]


# -- UNet --------------------------------------------------------------------

# block addresses: the LDM UNet numbers (block, sublayer) as sequential
# input/middle/output blocks, three a level
_UNET_ADDR: _RuleList = _rules([
    (r"^time_embedding\.linear_1\.", lambda m: "time_embed.0."),
    (r"^time_embedding\.linear_2\.", lambda m: "time_embed.2."),
    (r"^conv_in\.", lambda m: "input_blocks.0.0."),
    (r"^conv_norm_out\.", lambda m: "out.0."),
    (r"^conv_out\.", lambda m: "out.2."),
    (r"^down_blocks\.(\d+)\.resnets\.(\d+)\.",
     lambda m: f"input_blocks.{3 * int(m[1]) + int(m[2]) + 1}.0."),
    (r"^down_blocks\.(\d+)\.attentions\.(\d+)\.",
     lambda m: f"input_blocks.{3 * int(m[1]) + int(m[2]) + 1}.1."),
    (r"^down_blocks\.(\d+)\.downsamplers\.0\.conv\.",
     lambda m: f"input_blocks.{3 * (int(m[1]) + 1)}.0.op."),
    (r"^up_blocks\.(\d+)\.resnets\.(\d+)\.",
     lambda m: f"output_blocks.{3 * int(m[1]) + int(m[2])}.0."),
    (r"^up_blocks\.(\d+)\.attentions\.(\d+)\.",
     lambda m: f"output_blocks.{3 * int(m[1]) + int(m[2])}.1."),
    (r"^up_blocks\.(\d+)\.upsamplers\.0\.",
     lambda m: f"output_blocks.{3 * int(m[1]) + 2}.{1 if int(m[1]) == 0 else 2}."),
    (r"^mid_block\.attentions\.0\.", lambda m: "middle_block.1."),
    (r"^mid_block\.resnets\.(\d+)\.", lambda m: f"middle_block.{2 * int(m[1])}."),
])

# sublayers of a resnet (LDM's in_layers/out_layers)
_UNET_RESNET = [
    ("norm1.", "in_layers.0."),
    ("conv1.", "in_layers.2."),
    ("norm2.", "out_layers.0."),
    ("conv2.", "out_layers.3."),
    ("time_emb_proj.", "emb_layers.1."),
    ("conv_shortcut.", "skip_connection."),
]


def _apply_addr(key: str, rules: _RuleList) -> str:
    for pat, fn in rules:
        m = pat.match(key)
        if m:
            return fn(m) + key[m.end():]
    return key


def convert_unet_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        nk = k
        if ".resnets." in nk or nk.startswith("mid_block.resnets."):
            for hf, ldm in _UNET_RESNET:
                nk = nk.replace(hf, ldm)
        out[_apply_addr(nk, _UNET_ADDR)] = v
    return out


# -- VAE ---------------------------------------------------------------------

def _vae_addr_rules(n_up: int) -> _RuleList:
    """LDM reverses the decoder's up blocks, so the index depends on their
    count (4 in SD; a tiny VAE has fewer)."""
    hi = n_up - 1
    return _rules([
        (r"^encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.",
         lambda m: f"encoder.down.{m[1]}.block.{m[2]}."),
        (r"^encoder\.down_blocks\.(\d+)\.downsamplers\.0\.",
         lambda m: f"encoder.down.{m[1]}.downsample."),
        (r"^decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.",
         lambda m: f"decoder.up.{hi - int(m[1])}.block.{m[2]}."),
        (r"^decoder\.up_blocks\.(\d+)\.upsamplers\.0\.",
         lambda m: f"decoder.up.{hi - int(m[1])}.upsample."),
        (r"^(encoder|decoder)\.mid_block\.resnets\.(\d+)\.",
         lambda m: f"{m[1]}.mid.block_{int(m[2]) + 1}."),
        (r"^(encoder|decoder)\.mid_block\.attentions\.0\.",
         lambda m: f"{m[1]}.mid.attn_1."),
    ])


_VAE_ATTN = [
    ("group_norm.", "norm."),
    ("query.", "q."),
    ("key.", "k."),
    ("value.", "v."),
    ("proj_attn.", "proj_out."),
    # the newer diffusers spellings map to the same LDM names
    ("to_q.", "q."),
    ("to_k.", "k."),
    ("to_v.", "v."),
    ("to_out.0.", "proj_out."),
]


def convert_vae_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    n_up = 1 + max((int(m.group(1)) for k in sd
                    for m in [re.match(r"decoder\.up_blocks\.(\d+)\.", k)] if m), default=3)
    vae_addr = _vae_addr_rules(n_up)
    for k, v in sd.items():
        nk = _apply_addr(k, vae_addr)
        if ".attn_1." in nk:
            for hf, ldm in _VAE_ATTN:
                nk = nk.replace(hf, ldm)
        nk = nk.replace("conv_shortcut.", "nin_shortcut.")
        nk = nk.replace("conv_norm_out.", "norm_out.")
        # LDM stores the mid-attention projections as 1x1 convs
        if re.search(r"\.attn_1\.(q|k|v|proj_out)\.weight$", nk) and v.ndim == 2:
            v = v.reshape(*v.shape, 1, 1)
        out[nk] = v
    return out


def convert_text_enc_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return dict(sd)


# -- assembly ----------------------------------------------------------------


def _component_state_dict(model_path: str, subdir: str, names) -> Dict[str, torch.Tensor]:
    d = os.path.join(model_path, subdir)
    for name in names:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return _load_state_dict(p)
    raise FileNotFoundError(f"no weights for {subdir} in {model_path}")


def convert_to_ckpt(model_path: str, checkpoint_path: str, as_half: bool = False) -> None:
    """Write ``model.diffusion_model.*``, ``first_stage_model.*`` and
    ``cond_stage_model.transformer.*`` of the diffusers directory
    ``model_path`` as one torch ``.ckpt``; ``as_half`` casts the floating
    tensors to fp16 (reference to_ckpt_v2.py:198-232)."""
    if model_path is None:
        raise ValueError("Must provide a model path!")
    if checkpoint_path is None:
        raise ValueError("Must provide a checkpoint path!")
    unet = convert_unet_state_dict(_component_state_dict(
        model_path, "unet", ["diffusion_pytorch_model.bin", "diffusion_pytorch_model.safetensors"]))
    vae = convert_vae_state_dict(_component_state_dict(
        model_path, "vae", ["diffusion_pytorch_model.bin", "diffusion_pytorch_model.safetensors"]))
    text = convert_text_enc_state_dict(_component_state_dict(
        model_path, "text_encoder", ["pytorch_model.bin", "model.safetensors"]))

    state_dict = {}
    state_dict.update({"model.diffusion_model." + k: v for k, v in unet.items()})
    state_dict.update({"first_stage_model." + k: v for k, v in vae.items()})
    state_dict.update({"cond_stage_model.transformer." + k: v for k, v in text.items()})
    # each tensor a copy with its own storage: the reads are views of one
    # file buffer, which torch.save would otherwise write whole
    state_dict = {k: (v.to(torch.float16) if as_half and v.is_floating_point() else v).clone()
                  for k, v in state_dict.items()}
    torch.save({"state_dict": state_dict}, checkpoint_path)
