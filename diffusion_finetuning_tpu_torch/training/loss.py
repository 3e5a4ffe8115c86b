"""Training loss for LoRA / TI fine-tuning (port of the JAX ``training/loss.py``).

:func:`loss_step` is the JAX ``loss_step`` (:30-137):

1. ``latents = vae.encode(px).sample() * 0.18215`` (no gradient), or the
   posterior rebuilt from cached ``latent_moments`` (``LatentMomentCache``);
2. ``timesteps ~ U[0, T * t_mutliplier)`` per example;
3. ``noisy = add_noise(latents, noise, t)``;
4. text encoding (LoRA-aware, optionally with a trained token embedding) ->
   UNet eps/v prediction (LoRA-aware);
5. optional face-mask weighting: the mask resized to the latent grid by
   nearest neighbour (JAX's half-pixel index rule), ``+0.05``, divided by its
   mean, the class half of a prior-preservation batch padded with ones;
6. fp32 MSE, or ``mse(instance) + w * mse(prior)`` with prior preservation.

Batches use the JAX layouts: ``pixel_values`` (B, H, W, 3) in [-1, 1] or
uint8 (normalised on the device, ``v / 255 * 2 - 1`` in fp32),
``latent_moments`` (B, h, w, 2C), ``input_ids`` (B, 77), ``mask``
(B, H, W, 1) in [0, 1] or uint8.  The three random draws -- the posterior
sample, the noise and the timesteps -- come from a ``torch.Generator`` on
the model's device, or are handed in as ``draws`` (``sample`` and ``noise``
in the latents' (B, h, w, C) layout, ``timesteps`` (B,)): ``jax.random``
cannot be reproduced, so the parity tests pass JAX's draws in.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch.func import functional_call

from ..lora import attached
from ..models.vae import SCALING_FACTOR, DiagonalGaussian

TOKEN_EMBEDDING = "text_model.embeddings.token_embedding.weight"


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _nearest_index(n_out: int, n_in: int, device) -> torch.Tensor:
    """jax.image.resize's nearest rule: floor((i + 0.5) * n_in / n_out) in fp32."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def face_mask_weights(mask: torch.Tensor, batch: int, lh: int, lw: int) -> torch.Tensor:
    """(Bm, H, W, 1) mask -> (batch, 1, lh, lw) loss weights: nearest resize to
    the latent grid, ``+0.05``, divided by the mean, and ones for the class
    half of a prior-preservation batch (JAX :101-126)."""
    if mask.dtype == torch.uint8:
        mask = mask.float() / 255.0
    mask = mask.float()
    mask = mask[:, _nearest_index(lh, mask.shape[1], mask.device)]
    mask = mask[:, :, _nearest_index(lw, mask.shape[2], mask.device)]
    mask = mask.permute(0, 3, 1, 2) + 0.05
    mask = mask / mask.mean()
    if mask.shape[0] < batch:
        pad = torch.ones((batch - mask.shape[0],) + mask.shape[1:], dtype=mask.dtype,
                         device=mask.device)
        mask = torch.cat([mask, pad], dim=0)
    return mask


def loss_step(batch: Mapping[str, Any], *, unet, text_encoder, vae, scheduler,
              unet_lora: Optional[dict] = None, text_lora: Optional[dict] = None,
              token_embedding: Optional[torch.Tensor] = None,
              t_mutliplier: float = 1.0,   # sic -- the reference parameter name
              with_prior_preservation: bool = False, prior_loss_weight: float = 1.0,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
    """The scalar fp32 training loss; differentiable w.r.t. the LoRA trees'
    tensors and ``token_embedding`` (which replaces CLIP's token embedding,
    the TI path).  With prior preservation the batch is [instance; class]
    stacked along axis 0."""
    dev = _device(unet)
    draws = dict(draws or {})

    def get(key):
        return torch.as_tensor(batch[key]).to(dev)

    def draw(key, shape, dtype):
        given = draws.get(key)
        if given is not None:
            return torch.as_tensor(given).to(dev, dtype)
        return torch.randn(shape, generator=generator, device=dev, dtype=dtype)

    with torch.no_grad():
        if "latent_moments" in batch:
            # fp32 moments rebuilt in the VAE's dtype, so the sample matches
            # the direct encode path (JAX :54-63)
            posterior = DiagonalGaussian(get("latent_moments").permute(0, 3, 1, 2).to(vae.dtype))
        else:
            px = get("pixel_values")
            if px.dtype == torch.uint8:
                px = px.float() / 255.0 * 2.0 - 1.0
            posterior = vae.encode(px.permute(0, 3, 1, 2))
        mean = posterior.mean
        b, c, h, w = mean.shape
        eps = draw("sample", (b, h, w, c), mean.dtype).permute(0, 3, 1, 2)
        latents = ((mean + posterior.std * eps) * SCALING_FACTOR).float()

    noise = draw("noise", (b, h, w, c), torch.float32).permute(0, 3, 1, 2)
    t_max = int(scheduler.num_train_timesteps * t_mutliplier)
    timesteps = draws.get("timesteps")
    if timesteps is None:
        timesteps = torch.randint(0, t_max, (b,), generator=generator, device=dev)
    timesteps = torch.as_tensor(timesteps).to(dev).long()
    noisy = scheduler.add_noise(latents, noise, timesteps)

    ids = get("input_ids").long()
    with attached(text_encoder, text_lora):
        if token_embedding is None:
            encoder_hidden_states = text_encoder(ids)
        else:
            weight = text_encoder.get_parameter(TOKEN_EMBEDDING)
            encoder_hidden_states = functional_call(
                text_encoder, {TOKEN_EMBEDDING: token_embedding.to(weight.dtype)}, (ids,))

    with attached(unet, unet_lora):
        model_pred = unet(noisy.to(unet.dtype), timesteps,
                          encoder_hidden_states.to(unet.dtype)).float()

    target = scheduler.training_target(latents, noise, timesteps)
    if "mask" in batch and batch["mask"] is not None:
        weights = face_mask_weights(get("mask"), model_pred.shape[0], model_pred.shape[2],
                                    model_pred.shape[3])
        model_pred = model_pred * weights
        target = target * weights

    if with_prior_preservation:
        pred_i, pred_p = model_pred.chunk(2, dim=0)
        tgt_i, tgt_p = target.chunk(2, dim=0)
        return ((pred_i - tgt_i) ** 2).mean() + prior_loss_weight * ((pred_p - tgt_p) ** 2).mean()
    return ((model_pred - target) ** 2).mean()
