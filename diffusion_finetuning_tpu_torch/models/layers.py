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
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3 as conv3x3_op
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


class LoRAConv2d(_LoRAMixin, nn.Conv2d):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding)
        self._init_lora()

    def _conv(self, x: torch.Tensor, weight: torch.Tensor, bias, stride, padding):
        """One conv of the layer.  Routed: the fused 3x3 conv without a bias
        (JAX passes zeros, the same sum), then ``bias`` added in the
        activations' dtype, as JAX ``LoRAConv`` (:208-217, :234-238).
        Otherwise torch's conv."""
        if CONV_KERNEL and conv3x3_op.routes(x, weight, stride, padding):
            y = conv3x3_op.conv3x3(x, weight)
            return y if bias is None else y + bias.to(y.dtype)[:, None, None]
        return F.conv2d(x, weight, bias, stride, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv(x, self.weight, self.bias, self.stride, self.padding)
        if self.lora_up is None:
            return y
        h = self._conv(x, self.lora_down, None, self.stride, self.padding)
        return y + self.lora_scale.to(y.dtype) * self._conv(h, self.lora_up, None, 1, 0)


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
