"""Learning-rate sweep for DreamBooth-LoRA through one captured train step
(the repo's ``scripts/sweep_lr.py``).

The reference README picks the LoRA learning rate by hand ("use bigger lr
than you normally would", README.md:328-343); the workflow is a sweep.  The
LR is a runtime optimiser tensor (``multi_group_optimizer(runtime_lr_scale
=True)`` and ``set_lr_scale``) and every point restarts from the same
initial state copied into the same tensors, so the first point's CUDA
graphs (``FusedDispatcher``) replay for every later one: nothing is
captured again.

    python -m diffusion_finetuning_tpu_torch.scripts.sweep_lr MODEL_DIR INSTANCE_DIR out/ \\
        --prompt "a photo of sks" --base_lr 1e-4 --scales "0.25,1,4" \\
        --steps 200 --rank 4 [--device cpu]

Writes ``out/sweep.json`` (per-scale loss trajectories) and the best
point's LoRA as ``out/lora_best.pt``.
"""

import json
import os

import numpy as np
import torch

from .. import lora as lora_lib
from ..data.dataset import DataLoader, DreamBoothDataset
from ..models.schedulers import DDPMScheduler
from ..pipelines.pipeline import StableDiffusionPipeline
from ..training.checkpoint import named_tensors
from ..training.optim import ParamGroup, multi_group_optimizer, set_lr_scale
from ..training.train_step import (FusedDispatcher, TrainablePartition, build_train_step,
                                   init_train_state)
from ..training.trainer_util import compute_dtype, host_tree
from ..utils.cli import Fire


def run(pretrained_model_name_or_path: str, instance_data_dir: str, output_dir: str,
        prompt: str = "a photo of sks", base_lr: float = 1e-4, scales: str = "0.25,0.5,1,2,4",
        steps: int = 200, rank: int = 4, resolution: int = 512, batch_size: int = 1,
        seed: int = 0, steps_per_dispatch: int = 10, cache_latents: bool = True,
        mixed_precision: str = "bf16", device: str = "cuda"):
    os.makedirs(output_dir, exist_ok=True)
    if isinstance(scales, (tuple, list)):  # Fire parses "a,b,c" to a tuple
        scale_list = [float(s) for s in scales]
    else:
        scale_list = [float(s) for s in str(scales).split(",")]

    pipe = StableDiffusionPipeline.from_pretrained(
        pretrained_model_name_or_path, dtype=compute_dtype(mixed_precision), device=device)
    dev = pipe.device
    dataset = DreamBoothDataset(instance_data_root=instance_data_dir, instance_prompt=prompt,
                                tokenizer=pipe.tokenizer, size=resolution, seed=seed)
    pad_id = pipe.tokenizer.encoder[pipe.tokenizer.pad_token]

    targets = pipe.lora_targets("unet", lora_lib.DEFAULT_TARGET_REPLACE)
    optimizer = multi_group_optimizer({"unet_lora": ParamGroup(lr=base_lr, total_steps=steps)},
                                      max_grad_norm=1.0, runtime_lr_scale=True)
    step_fn = build_train_step(unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae,
                               scheduler=DDPMScheduler(pipe.scheduler_config),
                               optimizer=optimizer,
                               partition=TrainablePartition(unet_lora=True))
    dispatcher = FusedDispatcher(step_fn, spd=steps_per_dispatch)

    latent_cache = None
    if cache_latents:
        from ..training.latent_cache import LatentMomentCache

        latent_cache = LatentMomentCache(pipe.vae, device=dev)

    # one state for every point, reset in place: the captured steps read
    # its tensors by address
    state = init_train_state(optimizer, unet_lora=lora_lib.inject_trainable_lora(
        targets, torch.Generator().manual_seed(seed + 1), r=rank), device=dev)
    initial = {k: t.detach().clone() for k, t in named_tensors(state).items()}

    results, best = {}, (None, np.inf, None)
    for scale in scale_list:
        with torch.no_grad():
            torch._foreach_copy_(list(named_tensors(state).values()), list(initial.values()))
        state["step"] = 0
        set_lr_scale(state["opt_state"], "unet_lora", scale)
        loader = DataLoader(dataset, batch_size, pad_id, seed=seed)
        generator = torch.Generator(device=dev).manual_seed(seed)

        # one epoch-looping stream per scale (the trainers' batch stream):
        # whole epochs, not the shuffled prefixes a restart per group gives
        def batch_stream():
            while True:
                for batch in loader:
                    if latent_cache is not None:
                        batch = latent_cache.transform(batch)
                    yield batch

        stream = batch_stream()
        losses, done = [], 0
        while done < steps:
            take = min(steps_per_dispatch, steps - done)
            group = [batch for _, batch in zip(range(take), stream)]
            state, ls = dispatcher.run(state, group, generator)
            losses.extend(ls.float().cpu().tolist())
            done += len(group)

        tail = float(np.mean(losses[-max(1, len(losses) // 4):]))
        results[scale] = {"lr": base_lr * scale, "tail_loss": tail, "losses": losses}
        print(f"lr={base_lr * scale:g} (scale {scale}): tail loss {tail:.5f}")
        if tail < best[1]:
            best = (scale, tail, host_tree(state["params"]["unet_lora"]))

    with open(os.path.join(output_dir, "sweep.json"), "w") as f:
        json.dump({str(k): v for k, v in results.items()}, f, indent=1)
    lora_lib.save_lora_weight(best[2], targets, os.path.join(output_dir, "lora_best.pt"))
    print(f"best: scale {best[0]} (lr {base_lr * best[0]:g}) -> {output_dir}/lora_best.pt; "
          "trajectories in sweep.json")


if __name__ == "__main__":
    Fire(run)
