"""``lora_add``: merge two LoRAs, or a LoRA into a base model (port of the
JAX package's ``cli_lora_add.py``, reference cli_lora_add.py:17-118).

Modes:

* ``lpl``: ``x <- alpha * x1 + (1 - alpha) * x2`` over two flat ``.pt``
  LoRA lists, up and down of every pair, in fp32 and cast back to the first
  file's dtype (reference :49-58), with the ``.text_encoder.pt`` side-cars
  when ``with_text_lora``;
* ``upl``: read a diffusers directory with ``from_pretrained`` onto
  ``device``, merge the LoRA for good into the UNet weights (and the text
  encoder's), write a diffusers directory (reference :72-88);
* ``upl-ckpt-v2``: ``upl`` into a temporary directory, then an original-SD
  ``.ckpt`` in fp16 (reference :90-110).

    lora_add_torch A.pt B.pt OUT.pt --alpha 0.5 --mode lpl
    lora_add_torch MODEL_DIR LORA.pt OUT_DIR --alpha 0.8 --mode upl [--device cpu]
"""

from __future__ import annotations

import os
import shutil

import torch

from .lora import DEFAULT_TARGET_REPLACE, TEXT_ENCODER_DEFAULT_TARGET_REPLACE, _text_lora_path
from .utils.cli import Fire


def _interpolate_flat(path_1: str, path_2: str, alpha: float):
    l1 = torch.load(path_1, map_location="cpu", weights_only=True)
    l2 = torch.load(path_2, map_location="cpu", weights_only=True)
    if len(l1) != len(l2):
        raise ValueError(
            f"cannot lpl-merge {path_1} ({len(l1)} tensors) with {path_2} ({len(l2)} tensors): "
            "different target sets (e.g. linear-only vs conv-extension, or unet vs text "
            "encoder)")
    return [(alpha * x1.float() + (1 - alpha) * x2.float()).to(x1.dtype)
            for x1, x2 in zip(l1, l2)]


def _merge_into(model, lora_path: str, targets, alpha: float) -> None:
    """``W += alpha * up @ down`` for good on ``model``'s own weights."""
    from .lora import weight_apply_lora

    model.load_state_dict(weight_apply_lora(model.state_dict(), lora_path, targets,
                                            alpha=alpha, prefix=model.lora_prefix))


def add(path_1: str, path_2: str, output_path: str, alpha: float = 0.5, mode: str = "lpl",
        with_text_lora: bool = False, device: str = "cuda"):
    """``device``: where ``upl`` and ``upl-ckpt-v2`` load the model and
    merge (``lpl`` runs on the host)."""
    print("Lora Add, mode " + mode)
    if mode == "lpl":
        for _path_1, _path_2, opt in [(path_1, path_2, "unet")] + (
                [(_text_lora_path(path_1), _text_lora_path(path_2), "text_encoder")]
                if with_text_lora else []):
            print("Loading", _path_1, _path_2)
            if opt == "text_encoder":
                if not os.path.exists(_path_1):
                    print(f"No text encoder found in {_path_1}, skipping...")
                    continue
                if not os.path.exists(_path_2):
                    print(f"No text encoder found in {_path_2}, skipping...")
                    continue
            out_list = _interpolate_flat(_path_1, _path_2, alpha)
            if opt == "unet":
                print("Saving merged UNET to", output_path)
                torch.save(out_list, output_path)
            else:
                print("Saving merged text encoder to", _text_lora_path(output_path))
                torch.save(out_list, _text_lora_path(output_path))
        return

    if mode in ("upl", "upl-ckpt-v2"):
        from .models import hf_export
        from .pipelines.pipeline import StableDiffusionPipeline

        print(f"Merging UNET/CLIP from {path_1} with LoRA from {path_2} to {output_path}. "
              f"Merging ratio : {alpha}.")
        pipe = StableDiffusionPipeline.from_pretrained(path_1, device=device)
        _merge_into(pipe.unet, path_2, pipe.lora_targets("unet", DEFAULT_TARGET_REPLACE), alpha)
        if with_text_lora:
            text_path = _text_lora_path(path_2)
            if os.path.exists(text_path):
                _merge_into(pipe.text_encoder, text_path,
                            pipe.lora_targets("text_encoder",
                                              TEXT_ENCODER_DEFAULT_TARGET_REPLACE), alpha)

        if mode == "upl":
            hf_export.save_pretrained(pipe, output_path, source_dir=path_1)
            return

        from .to_ckpt_v2 import convert_to_ckpt

        _tmp_output = output_path + ".tmp"
        hf_export.save_pretrained(pipe, _tmp_output, source_dir=path_1)
        convert_to_ckpt(_tmp_output, output_path, as_half=True)
        shutil.rmtree(_tmp_output)
        return

    raise ValueError(f"Unknown mode {mode}")


def main():
    Fire(add)


if __name__ == "__main__":
    main()
