"""Alpha-scale sweep to a GIF (the reference's scripts/make_alpha_gifs.ipynb
workflow, the repo's ``scripts/make_alpha_gifs.py``): the same seed at
``frames`` LoRA scales in [0, 1), assembled into an animated gif.

    python -m diffusion_finetuning_tpu_torch.scripts.make_alpha_gifs MODEL_DIR LORA_PATH \\
        out.gif --prompt "style of <s1><s2>, baby lion" [--frames 50] [--steps 50] \\
        [--device cpu]
"""

import torch

from ..pipelines.pipeline import StableDiffusionPipeline, patch_pipe, tune_lora_scale_pipe
from ..utils.cli import Fire


def sweep(model_dir: str, lora_path: str, out_path: str = "out.gif",
          prompt: str = "a photo of <s1>", frames: int = 50, steps: int = 50,
          guidance_scale: float = 7.5, seed: int = 0, duration_ms: int = 100,
          device: str = "cuda"):
    pipe = StableDiffusionPipeline.from_pretrained(model_dir, dtype=torch.bfloat16,
                                                   device=device)
    patch_pipe(pipe, lora_path, patch_unet=True, patch_text=True, patch_ti=True)

    images = []
    for i in range(frames):
        alpha = i / frames
        # one request graph for the whole sweep: a retuned tree is copied
        # into its buffers, nothing is captured again
        tune_lora_scale_pipe(pipe, alpha)
        [img] = pipe(prompt, num_inference_steps=steps, guidance_scale=guidance_scale,
                     seed=seed)
        images.append(img)
        print(f"alpha={alpha:.2f} done")

    images[0].save(out_path, save_all=True, append_images=images[1:], duration=duration_ms,
                   loop=0)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    Fire(sweep)
