"""``lora_distill``: SVD-distill a full fine-tune into a rank-r LoRA (port of
the JAX package's ``cli_svd.py``, reference cli_svd.py:29-115).

Every LoRA-targetable linear weight of a tuned and a base directory, as
(out, in) on the device; per target ``delta = W_tuned - W_base`` in fp32,
its rank-r truncated SVD with the singular values folded into U, both
factors clamped at the signed ``clamp_quantile`` of their concatenated
entries (low bound: minus that value, reference cli_svd.py:79-84); saved as
the flat ``.pt`` pair (``path`` and ``path.text_encoder.pt``) that
``monkeypatch_lora`` reads.  The SVDs run on ``device`` (``torch.linalg.svd``;
the JAX package runs numpy's on the host); a missing card raises.

The sign contract.  A singular pair is defined only up to its sign, and
``torch.linalg.svd`` (LAPACK on the CPU, cuSOLVER on the card) and
``np.linalg.svd`` choose signs independently, and often differently on the
leading pairs of the same delta.  The clamp at a *signed* quantile makes
the output depend on those signs, so the port promises two things apart:

* :func:`svd_pair` equals numpy's ``(U * S, Vh)`` pair by pair once each
  pair's sign is aligned, and its product ``U @ Vh`` without alignment;
* :func:`clamp_pair` on given factors equals the JAX package's clamp on
  the same factors bit for bit: the quantile is numpy's ``linear`` one in
  fp32 (``(n - 1) * q`` in fp32, numpy's two-sided lerp), computed from the
  sorted entries with no size limit (``torch.quantile`` refuses more than
  2^24 elements).

    lora_distill_torch TUNED_DIR BASE_DIR --rank 4 --save_path out.pt [--device cpu]
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device
from .lora import (DEFAULT_TARGET_REPLACE, TEXT_ENCODER_DEFAULT_TARGET_REPLACE, LoraTarget,
                   _text_lora_path, module_name)
from .utils.cli import Fire


def extract_linear_weights(state_dict: Dict[str, torch.Tensor], targets: Sequence[LoraTarget],
                           prefix: str = "") -> List[torch.Tensor]:
    """The (out, in) fp32 weight at each LoRA target, in canonical order
    (reference cli_svd.py:19-26), where the state dict lives."""
    return [state_dict[module_name(t.path, prefix) + ".weight"].float() for t in targets]


def svd_pair(delta: torch.Tensor, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(U[:, :rank] * S[:rank], Vh[:rank])`` of ``delta``'s SVD in fp32, on
    its device.  Each pair's sign is the solver's (module docstring).  On
    the card the QR-based ``gesvd``: torch's default there, the Jacobi
    ``gesvdj``, stops short of fp32 accuracy on these shapes."""
    kw = {"driver": "gesvd"} if delta.is_cuda else {}
    u, s, vh = torch.linalg.svd(delta.float(), full_matrices=False, **kw)
    return u[:, :rank] * s[:rank][None, :], vh[:rank, :]


def _quantile(x: torch.Tensor, q: float) -> float:
    """numpy's ``quantile(x, q)`` (method ``linear``) for fp32 ``x``: the
    virtual index ``(n - 1) * q`` in fp32, then numpy's lerp between its
    two neighbours in fp32 (``a + d t``, or ``b - d (1 - t)`` from t = 0.5)."""
    s = torch.sort(x.flatten()).values
    n = s.numel()
    v = np.float32(n - 1) * np.float32(q)
    lo = math.floor(v)
    if lo >= n - 1:
        return float(s[-1])
    a, b = s[lo:lo + 2].cpu().numpy()
    t = v - np.float32(lo)
    d = b - a
    return float(b - d * (np.float32(1) - t) if t >= 0.5 else a + d * t)


def clamp_pair(U: torch.Tensor, Vh: torch.Tensor,
               clamp_quantile: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both factors clamped to ``[-hi, hi]``, ``hi`` the signed
    ``clamp_quantile`` of their concatenated entries (JAX ``_distill_one``
    :47-51, bit for bit on the same factors)."""
    hi = _quantile(torch.cat([U.flatten(), Vh.flatten()]), clamp_quantile)
    return U.clamp(-hi, hi), Vh.clamp(-hi, hi)


def svd_distill(target_model: str, base_model: str, rank: int = 4, clamp_quantile: float = 0.99,
                device: str = "cuda", save_path: str = "svd_distill.pt"):
    from .pipelines.pipeline import StableDiffusionPipeline

    device = resolve_device(device)  # no card: raise before reading anything
    pipe_base = StableDiffusionPipeline.from_pretrained(base_model, device=device)
    pipe_tuned = StableDiffusionPipeline.from_pretrained(target_model, device=device)
    groups = (("unet", DEFAULT_TARGET_REPLACE, save_path),
              ("text_encoder", TEXT_ENCODER_DEFAULT_TARGET_REPLACE, _text_lora_path(save_path)))
    pairs: Dict[str, int] = {}
    for name, replace, path in groups:
        targets = pipe_base.lora_targets(name, replace)
        base_mod, tuned_mod = getattr(pipe_base, name), getattr(pipe_tuned, name)
        prefix = base_mod.lora_prefix
        ori = extract_linear_weights(base_mod.state_dict(), targets, prefix)
        tuned = extract_linear_weights(tuned_mod.state_dict(), targets, prefix)
        uds: List[torch.Tensor] = []
        for w0, w1 in zip(ori, tuned):
            U, Vh = clamp_pair(*svd_pair(w1 - w0, rank), clamp_quantile)
            uds += [U.cpu(), Vh.cpu()]
        torch.save(uds, path)
        pairs[name] = len(uds) // 2
    print(f"Saved {pairs['unet']} UNet and {pairs['text_encoder']} CLIP rank-{rank} pairs "
          f"to {save_path}")


def main():
    Fire(svd_distill)


if __name__ == "__main__":
    main()
