"""The train step (port of the JAX ``training/train_step.py``, :56-219).

:func:`build_train_step` returns ``step(state, batch, generator) -> (state,
metrics)``: the gradients of ``loss_step`` w.r.t. the trainable tensors, the
multi-group AdamW update, then the TI embedding constraints, as the JAX step
(``jax.value_and_grad`` + ``optimizer.update``).  PyTorch runs it eagerly; on
the card every UNet attention call runs the flash-attention kernels (K1
forward, K3 backward) and every LoRA'd projection the fused LoRA kernel (K2)
forward.

The state is a dict, built by :func:`init_train_state`:

* ``params``: ``{"unet_lora": tree | None, "text_lora": tree | None,
  "ti_embeddings": (vocab, dim) | None}`` -- fp32 master tensors on the
  device that require grad; the LoRA ``scale`` leaves are plain fp32 tensors
  that never train (JAX ``_zero_scale_grads`` / ``_restore_scale_leaves``:
  they enter neither the clip norm nor AdamW's decay);
* ``static``: ``{"orig_embeddings", "index_updates"}`` for TI;
* ``opt_state``: the :class:`~.optim.OptimizerState`;
* ``step``: the number of batches seen.

The frozen UNet, CLIP text encoder and VAE are the modules handed to
:func:`build_train_step` (bf16 on the card).  Unlike the JAX step, which is
pure, this one UPDATES ``state`` IN PLACE (the parameters, the optimiser's
moments, the step count) and returns the same dict.  The JAX ``multi_step``,
``FusedDispatcher`` and ``jit_train_step`` (:274-612) have no counterpart
yet; theirs will be a CUDA-graph capture of this step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from .. import resolve_device
from .loss import loss_step
from .optim import MultiGroupOptimizer, apply_ti_constraints, trainable_tensors


@dataclasses.dataclass
class TrainablePartition:
    """What trains in a phase (JAX :56-71): the UNet and/or text LoRA trees,
    and with ``ti`` the token-embedding matrix; ``ti_constrained`` applies
    the inversion-phase treatment (frozen rows masked, norm decay)."""

    unet_lora: bool = True
    text_lora: bool = False
    ti: bool = False
    ti_constrained: bool = True


def master_tree(tree: Optional[Mapping[str, Any]], device) -> Optional[Dict[str, Any]]:
    """fp32 copies of a LoRA tree on ``device``: up/down require grad, the
    ``scale`` leaves do not."""
    if tree is None:
        return None
    out = {}
    for key, node in tree.items():
        if isinstance(node, Mapping):
            out[key] = master_tree(node, device)
        else:
            t = torch.as_tensor(node).detach().to(device, torch.float32).clone()
            out[key] = t if key == "scale" else t.requires_grad_(True)
    return out


def init_train_state(optimizer: MultiGroupOptimizer, *, unet_lora=None, text_lora=None,
                     ti_embeddings=None, index_updates=None, device="cuda") -> Dict[str, Any]:
    """The train state on ``device`` (the card unless the caller asks for
    the CPU): fp32 masters of the given trees and embeddings, the
    optimiser's state over them, step 0."""
    dev = resolve_device(device)
    emb = None
    static: Dict[str, Any] = {}
    if ti_embeddings is not None:
        orig = torch.as_tensor(ti_embeddings).detach().to(dev, torch.float32).clone()
        emb = orig.clone().requires_grad_(True)
        upd = (torch.zeros(orig.shape[0], dtype=torch.bool) if index_updates is None
               else torch.as_tensor(index_updates))
        static = {"orig_embeddings": orig, "index_updates": upd.to(dev, torch.bool)}
    params = {"unet_lora": master_tree(unet_lora, dev), "text_lora": master_tree(text_lora, dev),
              "ti_embeddings": emb}
    return {"params": params, "static": static,
            "opt_state": optimizer.init({k: v for k, v in params.items() if v is not None}),
            "step": 0}


def build_train_step(*, unet, text_encoder, vae, scheduler, optimizer: MultiGroupOptimizer,
                     partition: TrainablePartition, t_mutliplier: float = 1.0,
                     with_prior_preservation: bool = False, prior_loss_weight: float = 1.0,
                     clip_ti_decay: bool = True, ti_lr_schedule: Optional[Callable] = None,
                     grad_accum_steps: int = 1) -> Callable:
    """``step(state, batch, generator=None, draws=None) -> (state, metrics)``;
    ``metrics["loss"]`` is a 0-d tensor on the device (reading it syncs).
    ``draws`` hands ``loss_step`` its random draws (the parity tests)."""
    if partition.ti and partition.ti_constrained and clip_ti_decay and ti_lr_schedule is None:
        raise ValueError(
            "clip_ti_decay needs ti_lr_schedule (lambda = min(1, 100*lr)); "
            "without it the norm decay would silently be a no-op")
    partition = dataclasses.replace(partition)
    constrained = partition.ti and partition.ti_constrained

    def step(state, batch, generator: Optional[torch.Generator] = None, draws=None):
        params = state["params"]
        for t in trainable_tensors(params):
            t.grad = None
        loss = loss_step(
            batch, unet=unet, text_encoder=text_encoder, vae=vae, scheduler=scheduler,
            unet_lora=params.get("unet_lora"), text_lora=params.get("text_lora"),
            token_embedding=params["ti_embeddings"] if partition.ti else None,
            t_mutliplier=t_mutliplier, with_prior_preservation=with_prior_preservation,
            prior_loss_weight=prior_loss_weight, generator=generator, draws=draws)
        loss.backward()
        if constrained:
            # frozen vocab rows get zero gradient (JAX :171-178)
            emb = params["ti_embeddings"]
            if emb.grad is not None:
                emb.grad = torch.where(state["static"]["index_updates"][:, None], emb.grad, 0.0)
        optimizer.step(state["opt_state"])
        # renormalise / restore on accumulation boundaries only (JAX :188-207)
        if constrained and (grad_accum_steps <= 1 or (state["step"] + 1) % grad_accum_steps == 0):
            lr = ti_lr_schedule(state["step"]) if ti_lr_schedule is not None else 0.0
            emb = params["ti_embeddings"]
            with torch.no_grad():
                emb.copy_(apply_ti_constraints(emb, state["static"]["orig_embeddings"],
                                               state["static"]["index_updates"], lr,
                                               clip_ti_decay=clip_ti_decay))
        state["step"] += 1
        return state, {"loss": loss.detach()}

    return step
