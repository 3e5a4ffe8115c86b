"""Memory-efficient-attention shim (port of the JAX package's
``xformers_utils.py``, the reference's xformers surface).

The reference gates xformers attention behind a cached runtime probe that
checks the backward works per head dim (reference xformers_utils.py:16-39),
then walks the transformer blocks toggling it per block (42-70).  Here every
attention call goes to the flash-attention kernels by default
(``ops/attention.py``); this module keeps the reference's surface:

* :func:`test_flash_backwards` -- runs the flash forward and backward (K1
  and K3 on the card) at one head dim and holds O, dQ, dK and dV against
  :func:`~.ops.attention.plain_attention` and its autograd gradient;
* :func:`set_use_memory_efficient_attention_xformers` -- with a UNet
  config, probes each head dim of the model and turns the kernel off (an
  override of the router) only where the probe fails; without one, the
  global switch.

On the card a failing probe raises, naming the head dim and the error,
instead of turning the kernel off: the port runs no plain attention on the
card.  Only a CPU probe (the wrappers' plain versions) can return False.
"""

from __future__ import annotations

import functools

import torch

from . import resolve_device
from .ops import attention as attention_ops

PROBE_SEQ = 256
# bf16 kernel against the plain version's fp32 softmax, both in bf16 I/O:
# relative L2 error of O and of each gradient
PROBE_REL_L2 = 2e-2


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@functools.lru_cache(maxsize=None)
def test_flash_backwards(size: int, device="cuda") -> bool:
    """Probe that the flash forward and backward work at head dim ``size``
    (the analogue of the reference's test_xformers_backwards): one head,
    ``PROBE_SEQ`` queries and keys in bf16 on ``device`` (the card unless
    the caller asks for the CPU, where the wrappers run their plain
    versions); True when O, dQ, dK and dV are finite and within
    ``PROBE_REL_L2`` of the plain version's.  On the card a failure
    raises."""
    dev = resolve_device(device)
    try:
        g = torch.Generator(device=dev).manual_seed(size)
        q, k, v, do = (torch.randn((1, PROBE_SEQ, size), generator=g, device=dev,
                                   dtype=torch.bfloat16) for _ in range(4))
        outs = []
        for fn in (attention_ops.flash_attention, attention_ops.plain_attention):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = fn(*leaves, 1)
            o.backward(do)
            outs.append([o.detach()] + [t.grad for t in leaves])
        errs = [_rel_l2(a, b) if bool(torch.isfinite(a).all()) else float("nan")
                for a, b in zip(*outs)]
    except Exception as e:  # the kernel cannot run at this head dim
        if dev.type != "cpu":
            raise RuntimeError(f"flash attention fails at head dim {size}: {e!r}") from e
        print("Error enabling memory efficient attention for flash:", e)
        return False
    ok = all(err <= PROBE_REL_L2 for err in errs)
    if not ok and dev.type != "cpu":
        raise RuntimeError(
            f"flash attention disagrees with plain_attention at head dim {size}: "
            f"relative L2 of O, dQ, dK, dV {errs} (limit {PROBE_REL_L2})")
    return ok


def set_use_memory_efficient_attention_xformers(module_or_config=None, valid: bool = True,
                                                device="cuda") -> bool:
    """Turn the flash path on or off (reference xformers_utils.py:42-70).

    With a UNet config (or a module holding one as ``.config``), every head
    dim of the model is probed on its own and a failing one (on the CPU; on
    the card the probe raises) is turned off for its calls only (an
    override of ``ops.attention``); a passing one
    drops any override, and the global switch is turned on.  Without a
    config, the global switch, after a probe at head dim 64.  Returns
    whether the flash path stays on for at least one shape."""
    cfg = getattr(module_or_config, "config", module_or_config)
    if cfg is not None and hasattr(cfg, "block_out_channels"):
        head_dims = sorted({int(ch) // cfg.heads_for_block(i)
                            for i, ch in enumerate(cfg.block_out_channels)})
        if not valid:
            for d in head_dims:
                attention_ops.set_flash_override(head_dim=d, enabled=False)
            return False
        any_ok = False
        for d in head_dims:
            ok = test_flash_backwards(d, device)
            attention_ops.set_flash_override(head_dim=d, enabled=None if ok else False)
            any_ok = any_ok or ok
        if any_ok:
            attention_ops.set_flash_enabled(True)
        return any_ok
    if valid:
        valid = test_flash_backwards(64, device)
    attention_ops.set_flash_enabled(valid)
    return valid
