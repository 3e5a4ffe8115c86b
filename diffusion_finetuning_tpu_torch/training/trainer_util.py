"""What the trainers (``cli_lora_pti``, ``training_scripts/``) share beyond
the train step: the token table of the frozen text encoder, host copies of
what a checkpoint saves, the model swaps their flags ask for, and the log of
a run's dispatches (first-call seconds, steps a second after it, losses,
peak device memory).

The pipelines keep a TI-grown token table as a text override
(``pipe.text_params``); a trainer instead installs it in the text encoder
itself (:func:`install_token_table`), since its frozen text encoder runs
outside the pipeline: the train step reads the module's table, or the TI
master in its place when the embeddings train.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import graph as graph_lib
from ..models import hf_loading
from ..parallel.mesh import is_main_process
from ..models import clip_text, unet
from ..models.clip_text import TOKEN_EMBEDDING
from ..models.vae import AutoencoderKL
from ..models.weights import load_module
from ..ops import channels_last


def token_table(pipe) -> torch.Tensor:
    """The token table the pipe's text encoder runs with: the TI override
    of ``text_params`` where there is one, else the module's."""
    table = pipe.text_params.get(TOKEN_EMBEDDING)
    return pipe.text_encoder.get_parameter(TOKEN_EMBEDDING) if table is None else table


@torch.no_grad()
def install_token_table(pipe, table: torch.Tensor) -> None:
    """Make ``table`` (any dtype; cast to the module's) the text encoder's
    token table and drop a TI override of it.  A table of the module's shape
    is copied into the module's tensor (graphs that read it stay valid); a
    grown one replaces it."""
    emb: nn.Embedding = pipe.text_encoder.text_model.embeddings.token_embedding
    table = table.detach().to(emb.weight.device, emb.weight.dtype)
    if table.shape == emb.weight.shape:
        emb.weight.copy_(table)
    else:
        emb.weight = nn.Parameter(table.clone(), requires_grad=False)
        emb.num_embeddings = table.shape[0]
    pipe.text_params.pop(TOKEN_EMBEDDING, None)
    pipe.invalidate_merged_cache()


def host_tree(tree: Optional[Mapping[str, Any]]) -> Optional[Dict[str, Any]]:
    """A detached host copy of a LoRA tree (what a checkpoint writes)."""
    if tree is None:
        return None
    return {k: host_tree(v) if isinstance(v, Mapping) else v.detach().to("cpu", copy=True)
            for k, v in tree.items()}


def detached(tree):
    """A detached copy of a tensor or a tree of them, where it is."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return {k: detached(v) for k, v in tree.items()}


def load_vae(pipe, vae_dir: str) -> None:
    """Swap in a separately fine-tuned VAE from a diffusers directory
    (reference train_lora_dreambooth.py:581-587)."""
    cfg = hf_loading.vae_config_from_hf(hf_loading.read_json(os.path.join(vae_dir,
                                                                          "config.json")))
    sd = hf_loading.module_state_dict(
        AutoencoderKL, cfg,
        hf_loading.vae_state_dict_from_hf(hf_loading.load_model_dir_state_dict(vae_dir)))
    pipe.vae = load_module(AutoencoderKL, cfg, sd, pipe.dtype, pipe.device)
    pipe.vae_config = cfg


def enable_gradient_checkpointing(pipe) -> None:
    """Recompute the UNet's blocks in the backward pass (reference
    ``unet.enable_gradient_checkpointing``)."""
    pipe.unet_config = dataclasses.replace(pipe.unet_config, gradient_checkpointing=True)
    pipe.unet.config = pipe.unet_config


def main_print(*args, **kwargs) -> None:
    """``print`` on global rank 0 only (the trainers' I/O gating)."""
    if is_main_process():
        print(*args, **kwargs)


def mesh_graphs(mesh) -> bool:
    """Whether a trainer's steps may be captured in CUDA graphs on this
    mesh: not under gloo, whose collectives cannot be captured."""
    return mesh is None or mesh.backend != "gloo"


def compute_dtype(mixed_precision: Optional[str]) -> torch.dtype:
    """The trainers' ``mixed_precision`` flag: fp16 and bf16 train in bf16
    (as the JAX trainers do), anything else in fp32."""
    return torch.bfloat16 if mixed_precision in ("fp16", "bf16") else torch.float32


def kernel_launches() -> Dict[str, int]:
    """The kernel wrappers' launch counters (each adds one where it
    launches its kernel on the card; ``group_norm`` one a call, which
    launches its statistics kernel, then its normalisation kernel)."""
    from ..ops import conv3x3, flash_attention, group_norm, lora_matmul

    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_fwd_packed": flash_attention.packed_launches,
            "flash_attention_fwd_fp32": flash_attention.fp32_launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "flash_attention_bwd_fp32": flash_attention.bwd_fp32_launches,
            "lora_dense": lora_matmul.launches, "lora_dense_fp32": lora_matmul.fp32_launches,
            "conv3x3": conv3x3.launches, "conv3x3_fp32": conv3x3.fp32_launches,
            "group_norm": group_norm.launches}


class DispatchLog:
    """The dispatches of one run of ``FusedDispatcher.drive``: call
    :meth:`tick` first thing in the loop body with the dispatch's losses
    (device tensors, read once at the end) and :meth:`resume` last, so that
    a dispatch's wall holds the dispatch and the next group's staging,
    which ``drive`` does before it yields, but not the trainer's saves and
    prints.  The first dispatch holds the captures; ``steps_per_s`` is over
    the later ones (host clock, after a device sync); ``wall_s`` is the
    whole run's; ``launches`` are the kernel launches the run made (a
    captured graph's count at its warm-up and capture, none at its
    replays); ``graph_captures`` and ``graph_replays`` the CUDA graphs it
    captured and replayed (``graph.captures``, ``graph.replays``);
    ``nhwc_calls`` and ``nhwc_fallbacks`` the UNet's and VAE's convolutions
    and GroupNorms that ran channels-last, and those GroupNorms that the
    NHWC kernel did not take (``ops/channels_last.py``), each counted per
    Python call (a trainer's own steps feed NCHW: its validation images
    run channels-last); ``transformer_blocks`` and ``text_towers`` the
    UNet's transformer blocks and the text towers the Python calls ran
    (``models/unet.py``, ``models/clip_text.py``)."""

    def __init__(self, label: str, device: torch.device):
        self.label, self.device = label, device
        self.cuda = device.type == "cuda"
        if self.cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        self.launches0 = kernel_launches()
        self.graphs0 = (graph_lib.captures, graph_lib.replays)
        self.nhwc0 = (channels_last.calls, channels_last.fallbacks)
        self.model0 = (unet.transformer_blocks, clip_text.towers)
        self.start = self.t0 = time.perf_counter()
        self.walls: List[float] = []
        self.stepped: List[int] = []
        self._losses: List[torch.Tensor] = []

    def tick(self, losses: torch.Tensor, stepped: int) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.walls.append(now - self.t0)
        self.t0 = now
        self.stepped.append(stepped)
        self._losses.append(losses.detach().reshape(-1).clone())

    def resume(self) -> None:
        """The loop body's own work ends here: the next dispatch's wall
        starts now."""
        self.t0 = time.perf_counter()

    def summary(self) -> Dict[str, Any]:
        later = sum(self.walls[1:])
        out = {"label": self.label, "steps": sum(self.stepped),
               "wall_s": time.perf_counter() - self.start,
               "first_dispatch_s": self.walls[0] if self.walls else None,
               "steps_per_s": sum(self.stepped[1:]) / later if later > 0 else None,
               "losses": (torch.cat(self._losses).float().cpu().numpy()
                          if self._losses else np.zeros(0, np.float32)),
               "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                              if self.cuda else None),
               "launches": {k: n - self.launches0[k] for k, n in kernel_launches().items()},
               "graph_captures": graph_lib.captures - self.graphs0[0],
               "graph_replays": graph_lib.replays - self.graphs0[1],
               "nhwc_calls": channels_last.calls - self.nhwc0[0],
               "nhwc_fallbacks": channels_last.fallbacks - self.nhwc0[1],
               "transformer_blocks": unet.transformer_blocks - self.model0[0],
               "text_towers": clip_text.towers - self.model0[1]}
        sps = "n/a" if out["steps_per_s"] is None else f"{out['steps_per_s']:.3f}"
        peak = ("" if out["peak_bytes"] is None
                else f", peak memory {out['peak_bytes'] / 2**30:.2f} GiB")
        first = 0.0 if out["first_dispatch_s"] is None else out["first_dispatch_s"]
        print(f"{self.label}: {out['steps']} steps, first dispatch {first:.2f} s, then "
              f"{sps} steps/s{peak}")
        return out
