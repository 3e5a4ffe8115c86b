"""diffusion_finetuning_tpu_torch — the PyTorch/CUDA port of diffusion_finetuning_tpu.

A second package beside the JAX one, module for module (``models/unet.py``
here mirrors ``models/unet.py`` there).  Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas for the TPU is a hand-written CUDA
kernel for Hopper (``sm_90a``) under ``csrc/``, built with ``nvcc`` at first
use (``ops/_build.py``).

Entry points take a ``device`` that defaults to ``"cuda"`` and raise when
CUDA is absent, unless the caller asks for ``"cpu"``: on CPU tensors every
kernel wrapper runs its plain PyTorch version instead of the kernel.

This package never imports ``jax`` or ``diffusion_finetuning_tpu``; the
framework-free pieces it needs (``tree_util``, ``data/tokenizer``, the
diffusers key mapping) are its own copies.

The public surface is the JAX package's: ``lora.*`` re-exported, and the
dataset, pipeline and eval names resolved lazily from the port's modules.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA was asked for and
    is absent (nothing carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


from .lora import *  # noqa: E402,F401,F403
from .lora import (  # noqa: E402 -- explicit re-exports for static analyzers
    DEFAULT_TARGET_REPLACE,
    EMBED_FLAG,
    TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    UNET_DEFAULT_TARGET_REPLACE,
    LoraTarget,
)
from .lora import __all__ as _lora_all  # noqa: E402

__all__ = ["resolve_device"] + list(_lora_all)

# The dataset, pipeline and eval surfaces resolve lazily (PEP 562), as the
# JAX package's do (its __init__.py:42-76): they pull in PIL and the model
# code, and `import diffusion_finetuning_tpu_torch` stays light.
_LAZY = {
    **dict.fromkeys(("PivotalTuningDatasetCapation", "DreamBoothDataset",
                     "DreamBoothTiDataset", "PromptDataset", "OBJECT_TEMPLATE",
                     "STYLE_TEMPLATE", "DataLoader"), "data.dataset"),
    "CLIPTokenizer": "data.tokenizer",
    **dict.fromkeys(("StableDiffusionPipeline", "patch_pipe", "tune_lora_scale_pipe",
                     "apply_learned_embed_in_clip", "load_learned_embed_in_clip"),
                    "pipelines.pipeline"),
    **dict.fromkeys(("EXAMPLE_PROMPTS", "image_grid", "text_img_alignment",
                     "prepare_clip_model_sets", "evaluate_pipe", "visualize_progress"),
                    "utils.eval"),
    "convert_to_ckpt": "to_ckpt_v2",
    "set_use_memory_efficient_attention_xformers": "xformers_utils",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        value = getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
