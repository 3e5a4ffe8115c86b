"""AutoencoderKL, the SD VAE (port of the JAX ``models/vae.py``).

NCHW, diffusers state-dict names with the SD-era attention names
(``query/key/value/proj_attn``).  The encoder's downsample pads
asymmetrically (0, 1, 0, 1) before a stride-2 valid conv (JAX :88); the
single-head mid-block attention stays plain torch (JAX :64-84).  Inference
decodes ``latents / SCALING_FACTOR``; training encodes and scales by it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

SCALING_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    sample_size: int = 512

    @staticmethod
    def sd15() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                         norm_num_groups=4, sample_size=32)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over the channels (diffusers AttentionBlock)."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.query(h), self.key(h), self.value(h)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * c ** -0.5
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        h = self.proj_attn(torch.matmul(attn, v))
        return x + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, groups), ResnetBlock(ch, ch, groups)])
        self.attentions = nn.ModuleList([AttnBlock(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Block(nn.Module):
    def __init__(self, resnets, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.downsamplers = nn.ModuleList([downsample]) if downsample else None
        self.upsamplers = nn.ModuleList([upsample]) if upsample else None

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = list(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for i, ch in enumerate(chans):
            self.down_blocks.append(_Block(
                [ResnetBlock(prev if j == 0 else ch, ch, g) for j in range(cfg.layers_per_block)],
                downsample=Downsample(ch) if i < len(chans) - 1 else None))
            prev = ch
        self.mid_block = MidBlock(chans[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[0], 3, padding=1)
        self.mid_block = MidBlock(chans[0], g)
        self.up_blocks = nn.ModuleList()
        prev = chans[0]
        for i, ch in enumerate(chans):
            self.up_blocks.append(_Block(
                [ResnetBlock(prev if j == 0 else ch, ch, g)
                 for j in range(cfg.layers_per_block + 1)],
                upsample=Upsample(ch) if i < len(chans) - 1 else None))
            prev = ch
        self.conv_norm_out = nn.GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class DiagonalGaussian:
    """mean/logvar posterior (diffusers DiagonalGaussianDistribution)."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise; the noise is ``noise`` if given (cast to the
        mean's dtype), else drawn from ``generator``."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise.to(self.mean.device, self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """x (B, 3, H, W) in [-1, 1] -> posterior over (B, 4, H/f, W/f)."""
        return DiagonalGaussian(self.quant_conv(self.encoder(x.to(self.dtype))))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return self.decode(self.encode(x).sample(generator))
