"""Plain PyTorch Stable Diffusion models: the benchmark's reference.

A frozen copy of the UNet, CLIP text tower and VAE of the program under
test, with every kernel call replaced by plain operations: ``F.linear``,
``F.conv2d`` and attention written out in fp32, over blocks of query rows
so that a 9,216-token self-attention fits.  State-dict keys are diffusers'
names, as the program's, so one state dict made by the benchmark loads into
both.  A LoRA pair sits on a :class:`Linear` as ``lora = (up, down,
scale)``; :func:`merge_lora` folds one into the weights instead.  Every
product's inputs pass through ``numerics`` (the identity in fp32; the
controls round them).  The layer equations follow diffusers' SD 1.x / 2.x
UNet2DConditionModel, CLIPTextModel and AutoencoderKL.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import numerics as N

ATTENTION_BLOCK = 1024  # query rows per block of the written-out attention


class Linear(nn.Linear):
    lora: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None

    def forward(self, x):
        y = F.linear(N.act(x), N.weight(self.weight), self.bias)
        if self.lora is not None:
            up, down, scale = self.lora
            h = F.linear(N.act(x), N.weight(down))
            y = y + scale * F.linear(N.act(h), N.weight(up))
        return y


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(N.act(x), N.weight(self.weight), self.bias, self.stride, self.padding)


def attention(q, k, v, heads: int, mask: Optional[torch.Tensor] = None):
    """softmax(q k^T / sqrt(d) + mask) v over (B, S, heads * d) tensors, in
    blocks of query rows."""
    B, sq, C = q.shape
    d = C // heads
    qh = N.act(q).reshape(B, sq, heads, d).transpose(1, 2)
    kh = N.act(k).reshape(B, -1, heads, d).transpose(1, 2)
    vh = N.act(v).reshape(B, -1, heads, d).transpose(1, 2)
    outs = []
    for i in range(0, sq, ATTENTION_BLOCK):
        s = torch.matmul(qh[:, :, i:i + ATTENTION_BLOCK], kh.transpose(-1, -2)) * d ** -0.5
        if mask is not None:
            s = s + mask[i:i + ATTENTION_BLOCK]
        outs.append(torch.matmul(N.act(torch.softmax(s, dim=-1)), vh))
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(B, sq, C)


def lora_layers(model: nn.Module):
    return {name: m for name, m in model.named_modules() if isinstance(m, Linear)}


def attach_lora(model: nn.Module, pairs: Optional[Dict[str, Tuple]], scale: float = 1.0):
    """Set ``{module name: (up, down)}`` on the model's layers (None clears)."""
    layers = lora_layers(model)
    for m in layers.values():
        m.lora = None
    for name, (up, down) in (pairs or {}).items():
        layers[name].lora = (up, down, scale)


@torch.no_grad()
def merge_lora(model: nn.Module, pairs: Dict[str, Tuple], scale: float = 1.0):
    """W += scale * up @ down, in fp32, for every pair."""
    layers = lora_layers(model)
    for name, (up, down) in pairs.items():
        layers[name].weight += scale * (up.float() @ down.float()).to(layers[name].weight.dtype)


# -- UNet ---------------------------------------------------------------------

def timestep_embedding(t, dim, flip_sin_to_cos=True, shift=0.0):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    args = t.float()[:, None] * torch.exp(exponent / (half - shift))[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, dim):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(in_dim, dim), Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb_dim, groups, eps=1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class CrossAttention(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(ctx_dim, dim, bias=False)
        self.to_v = Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        return self.to_out[0](attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                                        self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, ctx_dim, heads)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=1e-5) for _ in range(3))

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class Transformer2DModel(nn.Module):
    def __init__(self, dim, ctx_dim, heads, groups, linear_proj):
        super().__init__()
        self.linear_proj = linear_proj
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        make = (lambda: Linear(dim, dim)) if linear_proj else (lambda: Conv2d(dim, dim, 1))
        self.proj_in, self.proj_out = make(), make()
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(dim, ctx_dim, heads)])

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if self.linear_proj:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.transformer_blocks[0](h, context)
        if self.linear_proj:
            h = self.proj_out(h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(b, hh, ww, c).permute(0, 3, 1, 2))
        return h + x


class _Block(nn.Module):
    def __init__(self, resnets, attentions=None, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.downsamplers = nn.ModuleList([down]) if down else None
        self.upsamplers = nn.ModuleList([up]) if up else None


class _Resample(nn.Module):
    def __init__(self, ch, down):
        super().__init__()
        self.down = down
        self.conv = Conv2d(ch, ch, 3, stride=2 if down else 1, padding=1)

    def forward(self, x):
        return self.conv(x if self.down else F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNet(nn.Module):
    """diffusers UNet2DConditionModel (SD 1.x / 2.x) from its config.json keys."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        chans = list(cfg["block_out_channels"])
        temb, g, ctx = chans[0] * 4, cfg["norm_num_groups"], cfg["cross_attention_dim"]
        heads = cfg["attention_head_dim"]
        heads = list(heads) if isinstance(heads, (list, tuple)) else [heads] * len(chans)
        lin = cfg["use_linear_projection"]
        n = cfg["layers_per_block"]

        def tf(ch, h):
            return Transformer2DModel(ch, ctx, h, g, lin)

        self.conv_in = Conv2d(cfg["in_channels"], chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chans[0], temb)
        self.down_blocks, self.up_blocks = nn.ModuleList(), nn.ModuleList()
        skips, prev = [chans[0]], chans[0]
        for i, (bt, ch) in enumerate(zip(cfg["down_block_types"], chans)):
            last = i == len(chans) - 1
            self.down_blocks.append(_Block(
                [ResnetBlock2D(prev if j == 0 else ch, ch, temb, g) for j in range(n)],
                [tf(ch, heads[i]) for _ in range(n)] if bt.startswith("CrossAttn") else None,
                down=None if last else _Resample(ch, True)))
            skips += [ch] * (n if last else n + 1)
            prev = ch
        mid = chans[-1]
        self.mid_block = _Block([ResnetBlock2D(mid, mid, temb, g),
                                 ResnetBlock2D(mid, mid, temb, g)], [tf(mid, heads[-1])])
        rev = list(reversed(chans))
        for i, bt in enumerate(cfg["up_block_types"]):
            ch, pch = rev[i], rev[max(i - 1, 0)]
            ins = [(pch if j == 0 else ch) + skips.pop() for j in range(n + 1)]
            self.up_blocks.append(_Block(
                [ResnetBlock2D(c, ch, temb, g) for c in ins],
                [tf(ch, heads[len(chans) - 1 - i]) for _ in range(n + 1)]
                if bt.startswith("CrossAttn") else None,
                up=_Resample(ch, False) if i < len(chans) - 1 else None))
        self.conv_norm_out = nn.GroupNorm(g, chans[0], eps=1e-5)
        self.conv_out = Conv2d(chans[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x, t, context):
        cfg = self.cfg
        t = torch.as_tensor(t, device=x.device).expand(x.shape[0])
        temb = self.time_embedding(timestep_embedding(
            t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"], cfg["freq_shift"]))
        h = self.conv_in(x)
        states = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, context)
                states.append(h)
            if blk.downsamplers is not None:
                h = blk.downsamplers[0](h)
                states.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, context)
        h = self.mid_block.resnets[1](h, temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, states.pop()], dim=1), temb)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, context)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


# -- CLIP text tower ----------------------------------------------------------

ACT = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x), "gelu": F.gelu}


class CLIPAttention(nn.Module):
    def __init__(self, h, heads):
        super().__init__()
        self.heads = heads
        self.k_proj, self.v_proj, self.q_proj, self.out_proj = (Linear(h, h) for _ in range(4))

    def forward(self, x, mask):
        return self.out_proj(attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                                       self.heads, mask))


class CLIPMLP(nn.Module):
    def __init__(self, h, inner, act):
        super().__init__()
        self.act = ACT[act]
        self.fc1, self.fc2 = Linear(h, inner), Linear(inner, h)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.self_attn = CLIPAttention(h, cfg["num_attention_heads"])
        self.layer_norm1 = nn.LayerNorm(h, eps=eps)
        self.mlp = CLIPMLP(h, cfg["intermediate_size"], cfg["hidden_act"])
        self.layer_norm2 = nn.LayerNorm(h, eps=eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = nn.Embedding(cfg["max_position_embeddings"],
                                               cfg["hidden_size"])


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg["num_hidden_layers"])])


class _TextModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])


class CLIPText(nn.Module):
    """CLIPTextModel's last hidden state (causal self-attention)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.text_model = _TextModel(cfg)

    def forward(self, ids):
        tm = self.text_model
        s = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(
            torch.arange(s, device=ids.device))[None]
        mask = torch.triu(torch.full((s, s), float("-inf"), device=ids.device), diagonal=1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


# -- VAE ----------------------------------------------------------------------

class VAEResnet(nn.Module):
    def __init__(self, cin, cout, g):
        super().__init__()
        self.norm1 = nn.GroupNorm(g, cin, eps=1e-6)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(g, cout, eps=1e-6)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class VAEAttention(nn.Module):
    def __init__(self, ch, g):
        super().__init__()
        self.group_norm = nn.GroupNorm(g, ch, eps=1e-6)
        self.query, self.key, self.value, self.proj_attn = (Linear(ch, ch) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.proj_attn(attention(self.query(h), self.key(h), self.value(h), 1))
        return x + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class _VAEMid(nn.Module):
    def __init__(self, ch, g):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch, g), VAEResnet(ch, ch, g)])
        self.attentions = nn.ModuleList([VAEAttention(ch, g)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _VAEDown(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _VAEBlock(nn.Module):
    def __init__(self, resnets, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.downsamplers = nn.ModuleList([down]) if down else None
        self.upsamplers = nn.ModuleList([up]) if up else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class _VAEEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chans, g, n = list(cfg["block_out_channels"]), cfg["norm_num_groups"], cfg["layers_per_block"]
        self.conv_in = Conv2d(cfg["in_channels"], chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for i, ch in enumerate(chans):
            self.down_blocks.append(_VAEBlock(
                [VAEResnet(prev if j == 0 else ch, ch, g) for j in range(n)],
                down=_VAEDown(ch) if i < len(chans) - 1 else None))
            prev = ch
        self.mid_block = _VAEMid(chans[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = Conv2d(chans[-1], 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(x))))


class _VAEDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chans, g = list(reversed(cfg["block_out_channels"])), cfg["norm_num_groups"]
        n = cfg["layers_per_block"]
        self.conv_in = Conv2d(cfg["latent_channels"], chans[0], 3, padding=1)
        self.mid_block = _VAEMid(chans[0], g)
        self.up_blocks = nn.ModuleList()
        prev = chans[0]
        for i, ch in enumerate(chans):
            self.up_blocks.append(_VAEBlock(
                [VAEResnet(prev if j == 0 else ch, ch, g) for j in range(n + 1)],
                up=_Resample(ch, False) if i < len(chans) - 1 else None))
            prev = ch
        self.conv_norm_out = nn.GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = Conv2d(chans[-1], cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


SCALING_FACTOR = 0.18215


class VAE(nn.Module):
    """AutoencoderKL: ``encode`` gives (mean, std) of the posterior,
    ``decode`` the image in [-1, 1]."""

    def __init__(self, cfg: dict):
        super().__init__()
        c = cfg["latent_channels"]
        self.encoder, self.decoder = _VAEEncoder(cfg), _VAEDecoder(cfg)
        self.quant_conv, self.post_quant_conv = Conv2d(2 * c, 2 * c, 1), Conv2d(c, c, 1)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, torch.exp(0.5 * logvar.clamp(-30.0, 20.0))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def build(kind: str, cfg: dict) -> nn.Module:
    return {"unet": UNet, "text_encoder": CLIPText, "vae": VAE}[kind](cfg)
