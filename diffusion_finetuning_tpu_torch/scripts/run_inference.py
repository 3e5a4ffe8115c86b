"""LoRA-patched txt2img (the reference's scripts/run_inference.ipynb
workflow, the repo's ``scripts/run_inference.py``): ``patch_pipe`` a
safetensors or ``.pt`` LoRA with its TI tokens, ``tune_lora_scale``,
generate.

    python -m diffusion_finetuning_tpu_torch.scripts.run_inference MODEL_DIR LORA_PATH \\
        --prompt "style of <s1><s2>, baby lion" --out out.png \\
        [--scheduler dpm --steps 25] [--n 4] [--unet_scale 0.8] [--device cpu]
"""

import os

import torch

from ..pipelines.pipeline import StableDiffusionPipeline, patch_pipe, tune_lora_scale_pipe
from ..utils.cli import Fire


def run(model_dir: str, lora_path: str = "", prompt: str = "a photo of <s1>",
        out: str = "out.png", negative_prompt: str = "", n: int = 1,
        height: int = 512, width: int = 512, steps: int = 50,
        guidance_scale: float = 7.5, scheduler: str = "ddim",
        unet_scale: float = 1.0, text_scale: float = 1.0, seed: int = 0,
        dtype: str = "bfloat16", device: str = "cuda"):
    """Render ``n`` images of ``prompt`` with an optional LoRA patched in.

    ``out`` gets a ``-{i}`` suffix when n > 1.  ``scheduler`` is any of
    ddim / pndm / dpm / euler / euler_a / lms (dpm at 20-25 steps is the
    fast serving default)."""
    pipe = StableDiffusionPipeline.from_pretrained(model_dir, dtype=getattr(torch, dtype),
                                                   device=device)
    if lora_path:
        patch_pipe(pipe, lora_path, patch_unet=True, patch_text=True, patch_ti=True)
        tune_lora_scale_pipe(pipe, unet_scale, which="unet")
        tune_lora_scale_pipe(pipe, text_scale, which="text")

    images = pipe([prompt] * n, negative_prompt=negative_prompt, height=height, width=width,
                  num_inference_steps=steps, guidance_scale=guidance_scale,
                  scheduler=scheduler, seed=seed)
    root, ext = os.path.splitext(out)
    for i, img in enumerate(images):
        path = out if n == 1 else f"{root}-{i}{ext}"
        img.save(path)
        print(f"wrote {path}")


if __name__ == "__main__":
    Fire(run)
