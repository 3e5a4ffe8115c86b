"""Runtime composition of two LoRAs (the reference's
scripts/merge_lora_with_lora.ipynb workflow, the repo's
``scripts/merge_lora_with_lora.py``): patch one LoRA, ``monkeypatch_add_lora``
a second on top with mixing weights, and render a scale ablation grid.

    python -m diffusion_finetuning_tpu_torch.scripts.merge_lora_with_lora MODEL_DIR \\
        LORA_A LORA_B out.png --prompt "..." [--alpha 0.5] [--beta 0.5] [--device cpu]
"""

import torch

from .. import lora as lora_lib
from ..pipelines.pipeline import StableDiffusionPipeline, patch_pipe, tune_lora_scale_pipe
from ..utils.cli import Fire
from ..utils.eval import image_grid


def merge(model_dir: str, lora_a: str, lora_b: str, out_path: str = "grid.png",
          prompt: str = "a photo of <s1>", alpha: float = 0.5, beta: float = 0.5,
          steps: int = 50, seed: int = 0, device: str = "cuda"):
    pipe = StableDiffusionPipeline.from_pretrained(model_dir, dtype=torch.bfloat16,
                                                   device=device)
    patch_pipe(pipe, lora_a, patch_unet=True, patch_text=True, patch_ti=True)

    targets = pipe.lora_targets("unet", lora_lib.DEFAULT_TARGET_REPLACE)
    pipe.unet_lora = lora_lib.monkeypatch_add_lora(pipe.unet_lora, lora_b, targets,
                                                   alpha=alpha, beta=beta)

    images = []
    for scale in (0.0, 0.25, 0.5, 0.75, 1.0):
        tune_lora_scale_pipe(pipe, scale)
        [img] = pipe(prompt, num_inference_steps=steps, seed=seed)
        images.append(img)
        print(f"scale={scale} done")

    image_grid(images, rows=1, cols=len(images)).save(out_path)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    Fire(merge)
