"""Convert ``.pt`` LoRA and textual-inversion files to one consolidated
safetensors file (port of the JAX package's ``cli_pt_to_safetensors.py``,
reference cli_pt_to_safetensors.py:19-85).

* Each input file is detected by what it holds: a dict is a TI embedding
  file, a list a flat LoRA.
* A LoRA's model name comes from its file name (``foo.pt`` -> ``unet``,
  ``foo.text_encoder.pt`` -> ``text_encoder``).
* Per-model settings come as name-prefixed flags, e.g. ``--unet.rank 8``
  or ``--text_encoder.target_modules "{'CLIPAttention'}"``.

    python -m diffusion_finetuning_tpu_torch.cli_pt_to_safetensors \\
        lora.pt lora.text_encoder.pt lora.ti.pt --outpath lora.safetensors
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from .lora import (DEFAULT_TARGET_REPLACE, TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
                   UNET_DEFAULT_TARGET_REPLACE, convert_loras_to_safeloras_with_embeds)
from .utils.cli import Fire


def _model_name_for(path: str) -> str:
    """``lora_weight.text_encoder.pt`` -> text_encoder, else unet."""
    parts = os.path.basename(path).split(".")
    return parts[-2] if len(parts) > 2 else "unet"


def _default_targets(name: str) -> set:
    if name == "unet":
        return UNET_DEFAULT_TARGET_REPLACE
    if name == "text_encoder":
        return TEXT_ENCODER_DEFAULT_TARGET_REPLACE
    return DEFAULT_TARGET_REPLACE


def _settings_for(name: str, settings: Dict[str, Any]) -> Tuple[set, int]:
    opts = {"target_modules": _default_targets(name), "rank": 4}
    for key, value in settings.items():
        model, _, field = key.partition(".")
        if model == name and field:
            opts[field] = value
    return opts["target_modules"], opts["rank"]


def convert(*paths, outpath, overwrite=False, **settings):
    """Bundle ``.pt`` LoRA and TI files into one safetensors file (the kind
    of each detected, per-model flags as in the module docstring)."""
    if os.path.exists(outpath) and not overwrite:
        raise ValueError(f"Output path {outpath} already exists, and overwrite is not True")

    modelmap: Dict[str, Tuple[str, set, int]] = {}
    embeds: Dict[str, Any] = {}
    for path in paths:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(payload, dict):
            print(f"Loading textual inversion embeds {list(payload)} from {path}")
            embeds.update(payload)
            continue
        name = _model_name_for(path)
        targets, rank = _settings_for(name, settings)
        print(f"Loading Lora for {name} from {path} (rank {rank}, targets {sorted(targets)})")
        modelmap[name] = (path, targets, rank)

    convert_loras_to_safeloras_with_embeds(modelmap, embeds, outpath)


def main():
    Fire(convert)


if __name__ == "__main__":
    main()
