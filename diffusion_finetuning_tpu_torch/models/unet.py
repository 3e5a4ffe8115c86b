"""UNet2DConditionModel (SD 1.x / 2.x denoiser), port of the JAX ``models/unet.py``.

NCHW inside, diffusers state-dict key names, so the JAX package's parameter
trees load through ``models/weights.py``.  Every attention and GEGLU
projection is a :class:`~.layers.LoRALinear` and the resnet convs are
:class:`~.layers.LoRAConv2d`, so the reference target sets address them;
:func:`unet_lora_targets` enumerates them in the JAX package's order (the
on-disk pair index).  Every attention call goes through ``ops.attention``:
the flash-attention kernel on the card.

Numerics as in the JAX model: GroupNorm eps 1e-5 in the resnets and 1e-6
before the transformer, LayerNorm eps 1e-5, exact-erf GEGLU, nearest
upsampling, to_q/to_k/to_v without bias and to_out with one.

``UNetConfig.gradient_checkpointing`` recomputes every ``ResnetBlock2D`` and
``Transformer2DModel`` in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the JAX model ``nn.remat``s
them (:299-303): the kernels' forwards then run twice per training step.
The recompute sees the LoRA tensors that were attached during the forward,
so a backward after :func:`lora.attached` has exited is still right.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..lora import LoraTarget
from ..ops.attention import attention as attention_op
from .layers import LoRAConv2d, LoRALinear


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # per-block head count (SD-era diffusers semantics of attention_head_dim)
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D")
    norm_num_groups: int = 32
    use_linear_projection: bool = False
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    gradient_checkpointing: bool = False

    def heads_for_block(self, i: int) -> int:
        if isinstance(self.attention_head_dim, (tuple, list)):
            return int(self.attention_head_dim[i])
        return int(self.attention_head_dim)

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def sd21() -> "UNetConfig":
        return UNetConfig(cross_attention_dim=1024, attention_head_dim=(5, 10, 20, 20),
                          use_linear_projection=True)

    @staticmethod
    def tiny(cross_attention_dim: int = 32) -> "UNetConfig":
        """CPU-fast config with the full block topology."""
        return UNetConfig(sample_size=8, block_out_channels=(8, 16, 16, 16),
                          layers_per_block=1, cross_attention_dim=cross_attention_dim,
                          attention_head_dim=2, norm_num_groups=4)


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings in fp32 (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = LoRAConv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = LoRAConv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = LoRAConv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention with LoRA-capable projections; self-attention
    when ``context`` is None."""

    def __init__(self, query_dim: int, context_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = LoRALinear(query_dim, query_dim, bias=False)
        self.to_k = LoRALinear(context_dim, query_dim, bias=False)
        self.to_v = LoRALinear(context_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([LoRALinear(query_dim, query_dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        out = attention_op(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = LoRALinear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf gelu, as diffusers


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class Transformer2DModel(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, groups: int = 32,
                 use_linear_projection: bool = False):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(dim, dim)
            self.proj_out = nn.Linear(dim, dim)
        else:
            self.proj_in = nn.Conv2d(dim, dim, 1)
            self.proj_out = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, context_dim, heads)])

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if self.use_linear_projection:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.transformer_blocks[0](h, context)
        if self.use_linear_projection:
            h = self.proj_out(h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(b, hh, ww, c).permute(0, 3, 1, 2))
        return h + x


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A down, mid or up block: resnets, optional attentions, optional
    resampler (diffusers' ModuleList names)."""

    def __init__(self, resnets, attentions=None, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.downsamplers = nn.ModuleList([downsample]) if downsample else None
        self.upsamplers = nn.ModuleList([upsample]) if upsample else None


_LORA = ("lora_up", "lora_down", "lora_scale")


def _remat(block: nn.Module, *args):
    """``block(*args)`` under activation checkpointing.  The LoRA tensors
    attached to the block's layers now are set again for the recompute in
    the backward pass (and the layers' state restored after it), so the
    recompute runs the same function as the forward did."""
    layers = [m for m in block.modules() if hasattr(m, "lora_up")]
    attached = [tuple(getattr(m, n) for n in _LORA) for m in layers]

    def run(*a):
        before = [tuple(getattr(m, n) for n in _LORA) for m in layers]
        for m, vals in zip(layers, attached):
            for n, val in zip(_LORA, vals):
                setattr(m, n, val)
        try:
            return block(*a)
        finally:
            for m, vals in zip(layers, before):
                for n, val in zip(_LORA, vals):
                    setattr(m, n, val)

    return checkpoint(run, *args, use_reentrant=False)


class UNet2DConditionModel(nn.Module):
    """``forward(sample (B, C, H, W), timesteps (B,) or scalar,
    encoder_hidden_states (B, S, cross_attention_dim))`` -> (B, C_out, H, W)
    in the model's dtype (its weights' dtype; inputs are cast to it)."""

    lora_prefix = ""

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        chans = list(cfg.block_out_channels)
        temb_dim = chans[0] * 4
        g = cfg.norm_num_groups
        ctx = cfg.cross_attention_dim

        def transformer(ch, heads):
            return Transformer2DModel(ch, ctx, heads, g, cfg.use_linear_projection)

        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim)

        self.down_blocks = nn.ModuleList()
        skip_chs = [chans[0]]
        prev = chans[0]
        for i, (btype, ch) in enumerate(zip(cfg.down_block_types, chans)):
            last = i == len(chans) - 1
            n = cfg.layers_per_block
            self.down_blocks.append(_Block(
                [ResnetBlock2D(prev if j == 0 else ch, ch, temb_dim, g) for j in range(n)],
                [transformer(ch, cfg.heads_for_block(i)) for _ in range(n)]
                if btype == "CrossAttnDownBlock2D" else None,
                downsample=None if last else Downsample2D(ch)))
            skip_chs += [ch] * (n if last else n + 1)
            prev = ch

        mid = chans[-1]
        self.mid_block = _Block(
            [ResnetBlock2D(mid, mid, temb_dim, g), ResnetBlock2D(mid, mid, temb_dim, g)],
            [transformer(mid, cfg.heads_for_block(len(chans) - 1))])

        rev = list(reversed(chans))
        self.up_blocks = nn.ModuleList()
        for i, btype in enumerate(cfg.up_block_types):
            ch, prev_ch = rev[i], rev[max(i - 1, 0)]
            n = cfg.layers_per_block + 1
            ins = [(prev_ch if j == 0 else ch) + skip_chs.pop() for j in range(n)]
            self.up_blocks.append(_Block(
                [ResnetBlock2D(cin, ch, temb_dim, g) for cin in ins],
                [transformer(ch, cfg.heads_for_block(len(chans) - 1 - i)) for _ in range(n)]
                if btype == "CrossAttnUpBlock2D" else None,
                upsample=Upsample2D(ch) if i < len(chans) - 1 else None))

        self.conv_norm_out = nn.GroupNorm(g, chans[0], eps=1e-5)
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample, timesteps, encoder_hidden_states):
        cfg = self.config
        dtype = self.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift).to(dtype)
        temb = self.time_embedding(t_emb)
        context = encoder_hidden_states.to(dtype)
        if cfg.gradient_checkpointing and torch.is_grad_enabled():
            call = _remat
        else:
            call = lambda block, *a: block(*a)

        h = self.conv_in(sample.to(dtype))
        states = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = call(res, h, temb)
                if blk.attentions is not None:
                    h = call(blk.attentions[j], h, context)
                states.append(h)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0](h)
                states.append(h)

        h = call(self.mid_block.resnets[0], h, temb)
        h = call(self.mid_block.attentions[0], h, context)
        h = call(self.mid_block.resnets[1], h, temb)

        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = call(res, torch.cat([h, states.pop()], dim=1), temb)
                if blk.attentions is not None:
                    h = call(blk.attentions[j], h, context)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h)

        return self.conv_out(F.silu(self.conv_norm_out(h)))


def unet_lora_targets(config: UNetConfig) -> list:
    """LoRA targets in the JAX package's order (models/unet.py:360):
    down_blocks, then up_blocks, then mid_block; per transformer block
    attn1 (to_q, to_k, to_v, to_out), GEGLU proj, attn2 (to_q, to_k, to_v,
    to_out).  The order is the on-disk pair index."""
    cfg = config
    targets = []

    def add_transformer_block(prefix: Tuple[str, ...], dim: int):
        tb = prefix + ("transformer_blocks_0",)
        ctx = cfg.cross_attention_dim
        for name in ("to_q", "to_k", "to_v", "to_out"):
            targets.append(LoraTarget(tb + ("attn1", name), dim, dim, "CrossAttention"))
        targets.append(LoraTarget(tb + ("ff", "net_0", "proj"), dim, dim * 8, "GEGLU"))
        for name, (i_f, o_f) in (("to_q", (dim, dim)), ("to_k", (ctx, dim)),
                                 ("to_v", (ctx, dim)), ("to_out", (dim, dim))):
            targets.append(LoraTarget(tb + ("attn2", name), i_f, o_f, "CrossAttention"))

    for i, (btype, ch) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
        if btype == "CrossAttnDownBlock2D":
            for j in range(cfg.layers_per_block):
                add_transformer_block((f"down_blocks_{i}_attentions_{j}",), ch)
    rev = list(reversed(cfg.block_out_channels))
    for i, btype in enumerate(cfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            for j in range(cfg.layers_per_block + 1):
                add_transformer_block((f"up_blocks_{i}_attentions_{j}",), rev[i])
    add_transformer_block(("mid_block_attentions_0",), cfg.block_out_channels[-1])
    return targets


def _resnet_channel_map(cfg: UNetConfig):
    """(path prefix, in, out) of every ResnetBlock2D, down -> up -> mid."""
    out = []
    chans = list(cfg.block_out_channels)
    prev = chans[0]
    down_outs = [chans[0]]
    for i, ch in enumerate(chans):
        for j in range(cfg.layers_per_block):
            out.append((f"down_blocks_{i}_resnets_{j}", prev if j == 0 else ch, ch))
            down_outs.append(ch)
        if i < len(chans) - 1:
            down_outs.append(ch)
        prev = ch
    rev = list(reversed(chans))
    for i, ch in enumerate(rev):
        prev_ch = rev[max(i - 1, 0)]
        for j in range(cfg.layers_per_block + 1):
            cin = (prev_ch if j == 0 else ch) + down_outs.pop()
            out.append((f"up_blocks_{i}_resnets_{j}", cin, ch))
    out.append(("mid_block_resnets_0", chans[-1], chans[-1]))
    out.append(("mid_block_resnets_1", chans[-1], chans[-1]))
    return out


def unet_conv_lora_targets(config: UNetConfig) -> list:
    """Conv2d LoRA targets (the LoraInjectedConv2d extension): conv1/conv2
    and, where present, conv_shortcut of every ResnetBlock2D."""
    targets = []
    for prefix, cin, cout in _resnet_channel_map(config):
        targets.append(LoraTarget((prefix, "conv1"), cin, cout, "ResnetBlock2D", (3, 3)))
        targets.append(LoraTarget((prefix, "conv2"), cout, cout, "ResnetBlock2D", (3, 3)))
        if cin != cout:
            targets.append(LoraTarget((prefix, "conv_shortcut"), cin, cout,
                                      "ResnetBlock2D", (1, 1)))
    return targets


def unet_all_lora_targets(config: UNetConfig) -> list:
    """Linear targets (canonical order), then the conv extension targets."""
    return unet_lora_targets(config) + unet_conv_lora_targets(config)
