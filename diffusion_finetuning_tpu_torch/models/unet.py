"""UNet2DConditionModel (SD 1.x / 2.x and SDXL denoiser), port of the JAX ``models/unet.py``.

NCHW shapes inside, diffusers state-dict key names, so the JAX package's parameter
trees load through ``models/weights.py``.  Every attention and GEGLU
projection is a :class:`~.layers.LoRALinear` and the resnet convs are
:class:`~.layers.LoRAConv2d`, so the reference target sets address them;
:func:`unet_lora_targets` enumerates them in the JAX package's order (the
on-disk pair index).  Every attention call goes through ``ops.attention``:
the flash-attention kernel on the card.

Layout: inside ``ops.channels_last.scope`` (the pipeline's calls on the
card) a channels-last ``sample`` keeps every activation channels-last:
``layers.Conv2d``, ``LoRAConv2d`` and ``GroupNorm`` follow their input, and
the transformers' permutes around ``proj_in``/``proj_out`` are views.
Outside it (the trainers) the modules run the NCHW code.

SDXL (``UNetConfig.sdxl``, which the JAX package does not have) adds two
things diffusers' config names: ``transformer_layers_per_block`` (a
``Transformer2DModel`` runs that many ``BasicTransformerBlock``s, the mid
block the last level's count, the up blocks the levels' counts reversed),
and ``addition_embed_type="text_time"``: ``forward`` then takes the pooled
text embedding and six size and crop ids, whose Fourier features
(``add_time_proj``) are joined to it and mapped by ``add_embedding`` onto
the time embedding every resnet reads.  :data:`transformer_blocks` counts
the blocks the Python calls ran (one per block per capture or eager call).

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
from .layers import Conv2d, GroupNorm, LoRAConv2d, LoRALinear

# BasicTransformerBlocks the UNet's Python calls ran (70 an SDXL call, 16 an
# SD 1.5 or 2.1 one); a replayed graph runs none
transformer_blocks = 0


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
    # transformer blocks a Transformer2DModel runs, per level (SDXL: 1, 2, 10)
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    # "text_time" (SDXL): the pooled text embedding and the size and crop ids
    # join the time embedding; None: no added conditioning
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    def heads_for_block(self, i: int) -> int:
        if isinstance(self.attention_head_dim, (tuple, list)):
            return int(self.attention_head_dim[i])
        return int(self.attention_head_dim)

    def depth_for_block(self, i: int) -> int:
        """Transformer blocks a ``Transformer2DModel`` of level ``i`` runs."""
        if isinstance(self.transformer_layers_per_block, (tuple, list)):
            return int(self.transformer_layers_per_block[i])
        return int(self.transformer_layers_per_block)

    @property
    def text_time(self) -> bool:
        """Whether ``forward`` takes SDXL's added conditioning."""
        if self.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"unsupported addition_embed_type {self.addition_embed_type!r}")
        return self.addition_embed_type == "text_time"

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def sd21() -> "UNetConfig":
        return UNetConfig(cross_attention_dim=1024, attention_head_dim=(5, 10, 20, 20),
                          use_linear_projection=True)

    @staticmethod
    def sdxl() -> "UNetConfig":
        """stabilityai/stable-diffusion-xl-base-1.0 ``unet/config.json``."""
        return UNetConfig(sample_size=128, block_out_channels=(320, 640, 1280),
                          cross_attention_dim=2048, attention_head_dim=(5, 10, 20),
                          down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                                            "CrossAttnDownBlock2D"),
                          up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                                          "UpBlock2D"),
                          use_linear_projection=True, transformer_layers_per_block=(1, 2, 10),
                          addition_embed_type="text_time", addition_time_embed_dim=256,
                          projection_class_embeddings_input_dim=2816)

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
        self.norm1 = GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = LoRAConv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = LoRAConv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = LoRAConv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x, silu=True))
        # the time embedding joins h inside norm2: h + emb is read only there
        h = self.conv2(self.norm2(h, add=self.time_emb_proj(F.silu(temb)), silu=True))
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
                 use_linear_projection: bool = False, depth: int = 1):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(groups, dim, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(dim, dim)
            self.proj_out = nn.Linear(dim, dim)
        else:
            self.proj_in = Conv2d(dim, dim, 1)
            self.proj_out = Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, context_dim, heads) for _ in range(depth)])

    def forward(self, x, context):
        global transformer_blocks
        transformer_blocks += len(self.transformer_blocks)
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if self.use_linear_projection:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for block in self.transformer_blocks:
            h = block(h, context)
        if self.use_linear_projection:
            h = self.proj_out(h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(b, hh, ww, c).permute(0, 3, 1, 2))
        return h + x


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

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
    in the model's dtype (its weights' dtype; inputs are cast to it).  With
    text-time conditioning (SDXL) ``forward`` also takes ``text_embeds``
    (B, pooled) and ``time_ids`` (B, 6)."""

    lora_prefix = ""

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        chans = list(cfg.block_out_channels)
        temb_dim = chans[0] * 4
        g = cfg.norm_num_groups
        ctx = cfg.cross_attention_dim

        def transformer(ch, level):
            return Transformer2DModel(ch, ctx, cfg.heads_for_block(level), g,
                                      cfg.use_linear_projection, cfg.depth_for_block(level))

        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim)
        if cfg.text_time:
            # diffusers' add_time_proj has no weights: timestep_embedding below
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                                   temb_dim)

        # registered in diffusers' order (down, up, then mid), so that
        # named_modules() walks the blocks in the canonical LoRA order
        self.down_blocks = nn.ModuleList()
        self.up_blocks = nn.ModuleList()
        skip_chs = [chans[0]]
        prev = chans[0]
        for i, (btype, ch) in enumerate(zip(cfg.down_block_types, chans)):
            last = i == len(chans) - 1
            n = cfg.layers_per_block
            self.down_blocks.append(_Block(
                [ResnetBlock2D(prev if j == 0 else ch, ch, temb_dim, g) for j in range(n)],
                [transformer(ch, i) for _ in range(n)]
                if btype == "CrossAttnDownBlock2D" else None,
                downsample=None if last else Downsample2D(ch)))
            skip_chs += [ch] * (n if last else n + 1)
            prev = ch

        mid = chans[-1]
        self.mid_block = _Block(
            [ResnetBlock2D(mid, mid, temb_dim, g), ResnetBlock2D(mid, mid, temb_dim, g)],
            [transformer(mid, len(chans) - 1)])

        rev = list(reversed(chans))
        for i, btype in enumerate(cfg.up_block_types):
            ch, prev_ch = rev[i], rev[max(i - 1, 0)]
            n = cfg.layers_per_block + 1
            ins = [(prev_ch if j == 0 else ch) + skip_chs.pop() for j in range(n)]
            self.up_blocks.append(_Block(
                [ResnetBlock2D(cin, ch, temb_dim, g) for cin in ins],
                [transformer(ch, len(chans) - 1 - i) for _ in range(n)]
                if btype == "CrossAttnUpBlock2D" else None,
                upsample=Upsample2D(ch) if i < len(chans) - 1 else None))

        self.conv_norm_out = GroupNorm(g, chans[0], eps=1e-5)
        self.conv_out = Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample, timesteps, encoder_hidden_states, text_embeds=None,
                time_ids=None):
        cfg = self.config
        dtype = self.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift).to(dtype)
        temb = self.time_embedding(t_emb)
        if cfg.text_time:
            if text_embeds is None or time_ids is None:
                raise ValueError("this UNet (addition_embed_type='text_time') needs "
                                 "text_embeds and time_ids")
            b = text_embeds.shape[0]
            time_embeds = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                             cfg.flip_sin_to_cos, cfg.freq_shift)
            added = torch.cat([text_embeds.float(), time_embeds.reshape(b, -1)], dim=-1)
            temb = temb + self.add_embedding(added.to(dtype))
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

        return self.conv_out(self.conv_norm_out(h, silu=True))


def unet_lora_targets(config: UNetConfig) -> list:
    """LoRA targets in the JAX package's order (models/unet.py:360):
    down_blocks, then up_blocks, then mid_block; per transformer block
    (``transformer_blocks_0`` .. ``_{depth - 1}`` of each transformer) attn1
    (to_q, to_k, to_v, to_out), GEGLU proj, attn2 (to_q, to_k, to_v,
    to_out).  The order is the on-disk pair index."""
    cfg = config
    targets = []

    def add_transformer(prefix: str, dim: int, level: int):
        ctx = cfg.cross_attention_dim
        for k in range(cfg.depth_for_block(level)):
            tb = (prefix, f"transformer_blocks_{k}")
            for name in ("to_q", "to_k", "to_v", "to_out"):
                targets.append(LoraTarget(tb + ("attn1", name), dim, dim, "CrossAttention"))
            targets.append(LoraTarget(tb + ("ff", "net_0", "proj"), dim, dim * 8, "GEGLU"))
            for name, (i_f, o_f) in (("to_q", (dim, dim)), ("to_k", (ctx, dim)),
                                     ("to_v", (ctx, dim)), ("to_out", (dim, dim))):
                targets.append(LoraTarget(tb + ("attn2", name), i_f, o_f, "CrossAttention"))

    last = len(cfg.block_out_channels) - 1
    for i, (btype, ch) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
        if btype == "CrossAttnDownBlock2D":
            for j in range(cfg.layers_per_block):
                add_transformer(f"down_blocks_{i}_attentions_{j}", ch, i)
    rev = list(reversed(cfg.block_out_channels))
    for i, btype in enumerate(cfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            for j in range(cfg.layers_per_block + 1):
                add_transformer(f"up_blocks_{i}_attentions_{j}", rev[i], last - i)
    add_transformer("mid_block_attentions_0", cfg.block_out_channels[-1], last)
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
