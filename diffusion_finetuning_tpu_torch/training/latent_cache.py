"""Latent-moment caching (port of the JAX ``training/latent_cache.py``).

Fine-tuning sets are a handful of images seen hundreds of times; with a
deterministic pixel pipeline the VAE encoder's output for an image never
changes.  :class:`LatentMomentCache` encodes each distinct example once and
swaps ``pixel_values`` for ``latent_moments`` (mean and clipped logvar,
(B, h, w, 2C) fp32 numpy, the JAX layout); ``loss_step`` rebuilds the
posterior from them and still samples it on every step, so the training
trajectory is that of the encode-every-step path.

Examples are keyed by a hash of their pixel bytes, not a dataset index, so
shuffling, prior-preservation batches and flipped variants are all right.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch

from .. import resolve_device


class LatentMomentCache:
    """Replaces ``pixel_values`` with cached ``latent_moments`` in batches.
    ``vae`` must live on ``device`` (the card unless the caller asks for
    the CPU)."""

    def __init__(self, vae, device="cuda"):
        self.device = resolve_device(device)
        self.vae = vae
        self._moments: Dict[bytes, np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    @torch.no_grad()
    def _encode(self, px: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(px[None]).to(self.device)
        if x.dtype == torch.uint8:
            # the same on-device normalisation as loss_step
            x = x.float() / 255.0 * 2.0 - 1.0
        post = self.vae.encode(x.permute(0, 3, 1, 2))
        moments = torch.cat([post.mean, post.logvar], dim=1).float()
        return moments.permute(0, 2, 3, 1)[0].cpu().numpy()

    def _example_moments(self, px: np.ndarray) -> np.ndarray:
        key = hashlib.sha1(px.tobytes()).digest()
        hit = self._moments.get(key)
        if hit is None:
            hit = self._moments[key] = self._encode(px)
            self.misses += 1
        else:
            self.hits += 1
        return hit

    def transform(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The batch with ``pixel_values`` swapped for ``latent_moments``
        (other keys untouched)."""
        px = np.asarray(batch["pixel_values"])
        moments = np.stack([self._example_moments(p) for p in px])
        out = {k: v for k, v in batch.items() if k != "pixel_values"}
        out["latent_moments"] = moments
        return out
