"""Training-progress visualisation (the reference's
scripts/lora_training_process_visualized.ipynb workflow, the repo's
``scripts/visualize_training_progress.py``): each checkpoint matching a glob
patched into the pipeline in turn, one fixed-seed image each, saved as a
progress grid.

    python -m diffusion_finetuning_tpu_torch.scripts.visualize_training_progress \\
        MODEL_DIR "out/step_*.safetensors" progress.png --prompt "a photo of <s1>" \\
        [--device cpu]
"""

from ..utils.cli import Fire
from ..utils.eval import image_grid, visualize_progress


def run(model_dir: str, checkpoints_glob: str, out_path: str = "progress.png",
        prompt: str = "a photo of <s1>", steps: int = 50, guidance_scale: float = 5.0,
        seed: int = 0, unet_scale: float = 1.0, text_scale: float = 1.0, limit: int = 10,
        device: str = "cuda"):
    """``checkpoints_glob`` may also be a list of paths."""
    imgs = visualize_progress(checkpoints_glob, prompt, model_dir, device=device,
                              num_inference_steps=steps, guidance_scale=guidance_scale,
                              seed=seed, unet_scale=unet_scale, text_sclae=text_scale,
                              limit=limit)
    image_grid(imgs, rows=1, cols=len(imgs)).save(out_path)
    print(f"wrote {out_path} ({len(imgs)} checkpoints)")


if __name__ == "__main__":
    Fire(run)
