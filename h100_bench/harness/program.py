"""The program under test, ``diffusion_finetuning_tpu_torch``, built from
the benchmark's inputs: everything here calls the program's public entry
points and hands them tensors the benchmark made."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from . import weights as W


def build_kernels(device) -> None:
    """Build (first run of a checkout) or load the program's CUDA kernels."""
    if torch.device(device).type == "cuda":
        from diffusion_finetuning_tpu_torch.ops import _build

        _build.build()


def configs(config: dict):
    """The program's config objects for the configuration file's groups."""
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig
    from diffusion_finetuning_tpu_torch.models.schedulers import SchedulerConfig
    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig
    from diffusion_finetuning_tpu_torch.models.vae import VAEConfig

    def pick(cls, group, **extra):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config[group].items() if k in names}
        return cls(**kw, **extra)

    return (pick(UNetConfig, "unet"), pick(VAEConfig, "vae"),
            pick(CLIPTextConfig, "text_encoder"), pick(SchedulerConfig, "scheduler"))


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_pipe(config: dict, seed: int, dtype: torch.dtype, device):
    """A StableDiffusionPipeline holding the seed's weights, made on the
    device in ``dtype``, and the benchmark's vocabulary."""
    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline

    ucfg, vcfg, tcfg, scfg = configs(config)
    sds = {k: W.state_dict(k, config[k], seed, dtype, device) for k in W.KINDS}
    vocab, merges = W.tokenizer_tables()
    return StableDiffusionPipeline(ucfg, sds["unet"], vcfg, sds["vae"], tcfg,
                                   sds["text_encoder"], CLIPTokenizer(vocab, merges), scfg,
                                   dtype=dtype, device=device)


def lora_tree(pipe, kind: str, pairs: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
              scale: float = 1.0) -> dict:
    """The program's LoRA tree (paths of its targets) holding ``pairs``; the
    program's default target set must be the benchmark's, name for name."""
    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.tree_util import tree_set

    model, replace = ((pipe.unet, lora_lib.UNET_DEFAULT_TARGET_REPLACE) if kind == "unet"
                      else (pipe.text_encoder, lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE))
    prefix = getattr(model, "lora_prefix", "")
    paths = {lora_lib.module_name(t.path, prefix): t.path
             for t in pipe.lora_targets("unet" if kind == "unet" else "text_encoder", replace)}
    if set(paths) != set(pairs):
        raise RuntimeError(f"the program's {kind} LoRA targets differ from the benchmark's: "
                           f"{sorted(set(paths) ^ set(pairs))[:4]}")
    tree: dict = {}
    for name, (up, down) in pairs.items():
        tree = tree_set(tree, paths[name], {
            "up": up, "down": down,
            "scale": torch.tensor(scale, dtype=torch.float32, device=up.device)})
    return tree


def free() -> None:
    """Return what the program held on the card (after its last reference
    is dropped): the reference runs after it."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

