"""LoRA-capable layers and activations (port of the JAX ``models/layers.py``).

:class:`LoRALinear` is ``nn.Linear`` with optional ``lora_up`` (out, r),
``lora_down`` (r, in) and ``lora_scale`` (a tensor, so retuning it never
rebuilds anything) set by :func:`lora.attached`.  With a LoRA set it runs
the fused LoRA dense (``ops/lora_matmul.py``): the Hopper kernel on a CUDA
tensor, its plain version on a CPU tensor.  Without one it is
``F.linear``.  The JAX layer keeps the fused kernel opt-in on the TPU
(layers.py:105, a v5e measurement); on the card it is the default.

:class:`LoRAConv2d` is ``nn.Conv2d`` with an optional rank-r pair of convs
(a kh x kw down to r channels, a 1x1 up).  Its convs are torch convs unless
:data:`CONV_KERNEL` is on (read once from ``DFT_CONV_PALLAS``, default off,
as the JAX ``CONV_PALLAS`` switch, layers.py:56): then every conv of the
layer that ``ops.conv3x3.supported`` accepts runs the fused 3x3 conv (K5 on
the card, its plain version on the CPU), as JAX ``LoRAConv.conv`` routes
(:208-217).  The LoRA down and up convs ask too and never pass (O = r; the
up conv is 1x1).

The LoRA buffers are not persistent: state dicts hold the base weights only.

:class:`Conv2d` (the UNet's and VAE's other convolutions), :class:`LoRAConv2d`
and :class:`GroupNorm` follow the memory format of the activation they get
inside ``ops.channels_last.scope`` (the pipeline's generation calls on the
card): a channels-last one keeps its layout, through a cached channels-last
filter and the NHWC GroupNorm (``ops/group_norm.py``, which folds in the
resnets' time-embedding add and SiLU).  An NCHW one, or any outside the
scope, runs the NCHW code: the same operations in the same order as before.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import channels_last as cl
from ..ops import conv3x3 as conv3x3_op
from ..ops import group_norm as group_norm_op
from ..ops import attention, flash_attention
from ..ops.lora_matmul import lora_dense

# route LoRAConv2d's 3x3 convs to ops.conv3x3 (tests and chip_smoke.py set it)
CONV_KERNEL = bool(int(os.environ.get("DFT_CONV_PALLAS", "0")))


def kernel_switches() -> tuple:
    """The two opt-in kernel switches as they stand (K5 for the resnet
    convs, K4's heads a CTA) and the attention router's switches: part of
    every CUDA graph's key, since a graph holds the kernels chosen when it
    was captured."""
    return CONV_KERNEL, flash_attention.DEFAULT_HEAD_PACK, attention.routing()


class _LoRAMixin:
    def _init_lora(self):
        self.register_buffer("lora_up", None, persistent=False)
        self.register_buffer("lora_down", None, persistent=False)
        self.register_buffer("lora_scale", None, persistent=False)

    def set_lora(self, up: torch.Tensor, down: torch.Tensor, scale) -> None:
        w = self.weight
        self.lora_up = up.to(w.device, w.dtype)
        self.lora_down = down.to(w.device, w.dtype)
        self.lora_scale = torch.as_tensor(scale, dtype=torch.float32).to(w.device)

    def clear_lora(self) -> None:
        self.lora_up = self.lora_down = self.lora_scale = None


class LoRALinear(_LoRAMixin, nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias)
        self._init_lora()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.lora_up is None:
            return F.linear(x, self.weight, self.bias)
        return lora_dense(x, self.weight, self.bias, self.lora_up, self.lora_down,
                          self.lora_scale)


def _nhwc_filter(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The filter a conv of ``x`` reads: the cached channels-last copy where
    it runs channels-last (counted), else ``weight``."""
    if not cl.takes_nhwc(x):
        return weight
    cl.calls += 1
    return cl.channels_last_filter(weight)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that reads a channels-last copy of its filter where it
    runs channels-last."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _nhwc_filter(x, self.weight), self.bias)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        # a load copies into the weight in place: a CUDA graph reads the
        # cached channels-last copy, rewritten here
        cl.refresh(self.weight)


class LoRAConv2d(_LoRAMixin, Conv2d):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding)
        self._init_lora()

    def _conv(self, x: torch.Tensor, weight: torch.Tensor, bias, stride, padding):
        """One conv of the layer.  Routed: the fused 3x3 conv without a bias
        (JAX passes zeros, the same sum), then ``bias`` added in the
        activations' dtype, as JAX ``LoRAConv`` (:208-217, :234-238); it
        takes an NCHW copy of a channels-last x and gives NCHW, copied back
        to channels-last where the layer runs channels-last.  Otherwise
        torch's conv."""
        if CONV_KERNEL and conv3x3_op.routes(x, weight, stride, padding):
            y = conv3x3_op.conv3x3(x, weight)
            y = y if bias is None else y + bias.to(y.dtype)[:, None, None]
            return y.contiguous(memory_format=torch.channels_last) if cl.takes_nhwc(x) else y
        return F.conv2d(x, _nhwc_filter(x, weight), bias, stride, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(x, self.weight, self.bias, self.stride, self.padding)
        if self.lora_up is None:
            return y
        h = self._conv(x, self.lora_down, None, self.stride, self.padding)
        return y + self.lora_scale.to(y.dtype) * self._conv(h, self.lora_up, None, 1, 0)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` with an optional per-(batch, channel) ``add`` (B, C)
    before it and an optional SiLU after it.  Where it runs channels-last
    the NHWC GroupNorm (the kernel on the card, its plain version on the
    CPU), y channels-last; on the card a call that needs a gradient runs
    PyTorch's (the kernel is forward only) and is counted
    (``channels_last.fallbacks``), and one the kernel does not take raises.
    Otherwise the add, ``F.group_norm`` and ``F.silu`` as separate
    operations."""

    def _torch(self, x, add, silu):
        if add is not None:
            x = x + add[:, :, None, None]
        y = F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        return F.silu(y) if silu else y

    def forward(self, x: torch.Tensor, add: Optional[torch.Tensor] = None,
                silu: bool = False) -> torch.Tensor:
        if not cl.takes_nhwc(x):
            return self._torch(x, add, silu)
        cl.calls += 1
        if x.is_cuda and _needs_grad(x, self.weight, self.bias, add):
            cl.fallbacks += 1
            return self._torch(x, add, silu).contiguous(memory_format=torch.channels_last)
        return group_norm_op.group_norm(x, self.num_groups, self.weight, self.bias, self.eps,
                                        add, silu)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


ACT2FN = {
    "quick_gelu": quick_gelu,
    "gelu": F.gelu,  # exact erf gelu
    "silu": F.silu,
    "swish": F.silu,
    "relu": F.relu,
    "mish": F.mish,
}
