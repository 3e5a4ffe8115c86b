"""LoRA-patched img2img (the reference's scripts/run_img2img.ipynb workflow,
the repo's ``scripts/run_img2img.py``): SDEdit-style image to image with a
safetensors or ``.pt`` LoRA and its TI tokens, with any sampler.

    python -m diffusion_finetuning_tpu_torch.scripts.run_img2img MODEL_DIR LORA_PATH \\
        init.png out.png --prompt "style of <s1><s2>, portrait" [--strength 0.75] \\
        [--scheduler dpm] [--device cpu]
"""

import numpy as np
import torch
from PIL import Image

from ..pipelines.pipeline import StableDiffusionPipeline, patch_pipe, tune_lora_scale_pipe
from ..utils.cli import Fire


def run(model_dir: str, lora_path: str, init_image: str, out_path: str = "out.png",
        prompt: str = "a photo of <s1>", strength: float = 0.75,
        unet_scale: float = 1.0, text_scale: float = 1.0,
        steps: int = 50, guidance_scale: float = 7.5, seed: int = 0,
        scheduler: str = "ddim", device: str = "cuda"):
    pipe = StableDiffusionPipeline.from_pretrained(model_dir, dtype=torch.bfloat16,
                                                   device=device)
    patch_pipe(pipe, lora_path, patch_unet=True, patch_text=True, patch_ti=True)
    tune_lora_scale_pipe(pipe, unet_scale, which="unet")
    tune_lora_scale_pipe(pipe, text_scale, which="text")

    init = np.asarray(Image.open(init_image).convert("RGB"))
    [img] = pipe.img2img(prompt, init, strength=strength, num_inference_steps=steps,
                         scheduler=scheduler, guidance_scale=guidance_scale, seed=seed)
    img.save(out_path)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    Fire(run)
