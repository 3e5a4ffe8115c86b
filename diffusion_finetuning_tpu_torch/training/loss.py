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
:func:`draw_inputs` makes the generator's draws for a batch ahead of the
step, as a captured train step needs them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch.func import functional_call

from ..lora import attached
from ..models.vae import DiagonalGaussian

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


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A data-parallel rank's part of the global batch (``parallel/``): it
    holds rows ``lo .. lo + B - 1`` of ``total``; ``gather_mask`` maps the
    node's face mask to the global batch's (the nodes' masks end to end)."""

    lo: int
    total: int
    gather_mask: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def rows(self, b: int) -> slice:
        return slice(self.lo, self.lo + b)


def draw_inputs(batch: Mapping[str, Any], *, vae, scheduler, t_mutliplier: float = 1.0,
                generator: Optional[torch.Generator] = None,
                shard: Optional[RowShard] = None) -> Dict[str, torch.Tensor]:
    """The three draws :func:`loss_step` makes for ``batch`` from
    ``generator`` on the VAE's device, in its order: the posterior sample's
    noise in the VAE's dtype and the forward noise in fp32, both (B, h, w,
    C) on the latent grid, then the timesteps in [0, T * t_mutliplier).
    With ``shard`` the global batch's draws are made, as one device would
    make them, and this rank's rows kept."""
    dev = _device(vae)
    if "latent_moments" in batch:
        b, h, w, c2 = batch["latent_moments"].shape
        c = c2 // 2
    else:
        b, hp, wp, _ = batch["pixel_values"].shape
        f = 2 ** (len(vae.config.block_out_channels) - 1)
        h, w, c = hp // f, wp // f, vae.config.latent_channels
    t_max = int(scheduler.num_train_timesteps * t_mutliplier)
    n = b if shard is None else shard.total
    out = {"sample": torch.randn((n, h, w, c), generator=generator, device=dev, dtype=vae.dtype),
           "noise": torch.randn((n, h, w, c), generator=generator, device=dev,
                                dtype=torch.float32),
           "timesteps": torch.randint(0, t_max, (n,), generator=generator, device=dev)}
    return out if shard is None else shard_draws(out, shard, b)


def shard_draws(draws: Mapping[str, Any], shard: RowShard, b: int) -> Dict[str, Any]:
    """A rank's rows of the global batch's draws; draws that already have
    the rank's ``b`` rows are kept as they are."""
    if len(draws["timesteps"]) == b:
        return dict(draws)
    return {k: v[shard.rows(b)] for k, v in draws.items()}


def _share(sq: torch.Tensor, shard: RowShard, prior: bool, weight: float) -> torch.Tensor:
    """A rank's share of the global loss from its rows' squared errors:
    each term's mean over its rows times their fraction of the term's
    global rows, so the ranks' shares sum to the global loss.  With prior
    preservation the global batch's first half is the instance term, the
    second the class term (JAX :130-135), wherever a rank's rows fall."""
    b = sq.shape[0]
    if not prior:
        return sq.mean() * (b / shard.total)
    half = shard.total // 2
    n_inst = min(max(half - shard.lo, 0), b)
    terms = []
    if n_inst:
        terms.append(sq[:n_inst].mean() * (n_inst / half))
    if b - n_inst:
        terms.append(weight * (sq[n_inst:].mean() * ((b - n_inst) / half)))
    return terms[0] if len(terms) == 1 else terms[0] + terms[1]


def loss_step(batch: Mapping[str, Any], *, unet, text_encoder, vae, scheduler,
              unet_lora: Optional[dict] = None, text_lora: Optional[dict] = None,
              token_embedding: Optional[torch.Tensor] = None,
              t_mutliplier: float = 1.0,   # sic -- the reference parameter name
              with_prior_preservation: bool = False, prior_loss_weight: float = 1.0,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Mapping[str, Any]] = None,
              shard: Optional[RowShard] = None) -> torch.Tensor:
    """The scalar fp32 training loss; differentiable w.r.t. the LoRA trees'
    tensors and ``token_embedding`` (which replaces CLIP's token embedding,
    the TI path).  With prior preservation the batch is [instance; class]
    stacked along axis 0.

    With ``shard`` the batch is a data-parallel rank's rows of the global
    batch and the result is its share of the global loss (the ranks' shares
    sum to it): the global batch's draws, the face mask normalised by the
    global mask's mean, and every mean over its global count.  ``draws``
    may then hold the global batch's rows or the rank's."""
    dev = _device(unet)
    if draws is None:
        draws = draw_inputs(batch, vae=vae, scheduler=scheduler, t_mutliplier=t_mutliplier,
                            generator=generator, shard=shard)
    elif shard is not None:
        draws = shard_draws(draws, shard, len(batch["input_ids"]))

    def get(key):
        return torch.as_tensor(batch[key]).to(dev)

    def draw(key, dtype):
        return torch.as_tensor(draws[key]).to(dev, dtype)

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
        eps = draw("sample", mean.dtype).permute(0, 3, 1, 2)
        latents = ((mean + posterior.std * eps) * vae.config.scaling_factor).float()

    noise = draw("noise", torch.float32).permute(0, 3, 1, 2)
    timesteps = torch.as_tensor(draws["timesteps"]).to(dev).long()
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
    b = model_pred.shape[0]
    if "mask" in batch and batch["mask"] is not None:
        mask = get("mask")
        if shard is None:
            weights = face_mask_weights(mask, b, model_pred.shape[2], model_pred.shape[3])
        else:
            if shard.gather_mask is not None:
                mask = shard.gather_mask(mask)
            weights = face_mask_weights(mask, shard.total, model_pred.shape[2],
                                        model_pred.shape[3])[shard.rows(b)]
        model_pred = model_pred * weights
        target = target * weights

    if shard is not None and (shard.lo, shard.total) != (0, b):
        return _share((model_pred - target) ** 2, shard, with_prior_preservation,
                      prior_loss_weight)
    if with_prior_preservation:
        pred_i, pred_p = model_pred.chunk(2, dim=0)
        tgt_i, tgt_p = target.chunk(2, dim=0)
        return ((pred_i - tgt_i) ** 2).mean() + prior_loss_weight * ((pred_p - tgt_p) ** 2).mean()
    return ((model_pred - target) ** 2).mean()
