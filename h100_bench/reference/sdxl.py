"""Plain PyTorch Stable Diffusion XL 1.0 base: the reference of the
``sdxl_base`` configuration, in fp32 with TF32 off.

It builds on ``models.py`` (the SD reference): the same layers, written-out
attention, ``numerics`` rounding of every product's inputs, LoRA slots and
merges, and the same VAE.  State-dict keys are diffusers' and transformers'
names, so one state dict made by the benchmark loads into this and into the
program alike.  Imports neither JAX nor the program.

The layer equations follow diffusers' ``UNet2DConditionModel`` with
``transformer_layers_per_block`` and ``addition_embed_type="text_time"``,
transformers' ``CLIPTextModel`` and ``CLIPTextModelWithProjection``, and
``StableDiffusionXLPipeline``.  Departures from those modules:

* the UNet keeps ``models.py``'s block layout (three levels here); the mid
  block runs the last level's stack depth and the up blocks the levels'
  depths reversed, as diffusers builds them;
* the towers are read as the SDXL pipeline reads them: ``hidden_states[-2]``
  (no final norm) of each, and tower 2's ``text_embeds`` (the final-normed
  state at the highest token id, transformers' rule for ``eos_token_id`` 2,
  through the bias-free ``text_projection``); tower 1's last layer is not
  run, since nothing reads it;
* classifier-free guidance with the published ``force_zeros_for_empty_prompt``:
  the benchmark's negative prompts are empty, so the unconditional context
  and pooled embedding are zeros;
* ``time_ids`` are ``[h, w, 0, 0, h, w]`` (original size, crop top-left,
  target size), the same for both halves;
* both tokenizers are the benchmark's own (``tokenizer.py``), padding with
  the end-of-text token;
* the VAE decodes ``latents / scaling_factor`` (0.13025) in fp32 (the
  published ``force_upcast`` upcasts fp16 only).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from . import models as M
from . import numerics
from .pipeline import Schedule as _Schedule


class Transformer2DStack(M.Transformer2DModel):
    """``Transformer2DModel`` with ``depth`` transformer blocks."""

    def __init__(self, dim, ctx_dim, heads, groups, linear_proj, depth):
        super().__init__(dim, ctx_dim, heads, groups, linear_proj)
        self.transformer_blocks = nn.ModuleList(
            [M.BasicTransformerBlock(dim, ctx_dim, heads) for _ in range(depth)])

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if self.linear_proj:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for block in self.transformer_blocks:
            h = block(h, context)
        if self.linear_proj:
            h = self.proj_out(h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(b, hh, ww, c).permute(0, 3, 1, 2))
        return h + x


def _per_level(v, n: int) -> List[int]:
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


class UNet(nn.Module):
    """diffusers UNet2DConditionModel (SDXL) from its config.json keys:
    ``forward(x, t, context, text_embeds, time_ids)``."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        chans = list(cfg["block_out_channels"])
        temb, g, ctx = chans[0] * 4, cfg["norm_num_groups"], cfg["cross_attention_dim"]
        heads = _per_level(cfg["attention_head_dim"], len(chans))
        depth = _per_level(cfg.get("transformer_layers_per_block", 1), len(chans))
        lin = cfg["use_linear_projection"]
        n = cfg["layers_per_block"]

        def tf(level):
            return Transformer2DStack(chans[level], ctx, heads[level], g, lin, depth[level])

        self.conv_in = M.Conv2d(cfg["in_channels"], chans[0], 3, padding=1)
        self.time_embedding = M.TimestepEmbedding(chans[0], temb)
        self.add_embedding = M.TimestepEmbedding(cfg["projection_class_embeddings_input_dim"],
                                                 temb)
        self.down_blocks, self.up_blocks = nn.ModuleList(), nn.ModuleList()
        skips, prev = [chans[0]], chans[0]
        last = len(chans) - 1
        for i, (bt, ch) in enumerate(zip(cfg["down_block_types"], chans)):
            self.down_blocks.append(M._Block(
                [M.ResnetBlock2D(prev if j == 0 else ch, ch, temb, g) for j in range(n)],
                [tf(i) for _ in range(n)] if bt.startswith("CrossAttn") else None,
                down=None if i == last else M._Resample(ch, True)))
            skips += [ch] * (n if i == last else n + 1)
            prev = ch
        mid = chans[-1]
        self.mid_block = M._Block([M.ResnetBlock2D(mid, mid, temb, g),
                                   M.ResnetBlock2D(mid, mid, temb, g)], [tf(last)])
        rev = list(reversed(chans))
        for i, bt in enumerate(cfg["up_block_types"]):
            ch, pch = rev[i], rev[max(i - 1, 0)]
            ins = [(pch if j == 0 else ch) + skips.pop() for j in range(n + 1)]
            self.up_blocks.append(M._Block(
                [M.ResnetBlock2D(c, ch, temb, g) for c in ins],
                [tf(last - i) for _ in range(n + 1)] if bt.startswith("CrossAttn") else None,
                up=M._Resample(ch, False) if i < last else None))
        self.conv_norm_out = nn.GroupNorm(g, chans[0], eps=1e-5)
        self.conv_out = M.Conv2d(chans[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x, t, context, text_embeds, time_ids):
        cfg = self.cfg
        t = torch.as_tensor(t, device=x.device).expand(x.shape[0])
        flip, shift = cfg["flip_sin_to_cos"], cfg["freq_shift"]
        temb = self.time_embedding(M.timestep_embedding(t, cfg["block_out_channels"][0],
                                                        flip, shift))
        b = text_embeds.shape[0]
        tid = M.timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"],
                                   flip, shift).reshape(b, -1)
        temb = temb + self.add_embedding(torch.cat([text_embeds, tid], dim=-1))
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


class CLIPTower(M.CLIPText):
    """A text tower read as SDXL reads it: ``forward(ids)`` -> (hidden
    state after the second-to-last layer, pooled projection or None)."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        # transformers' class decides (SDXL's tower 1 lists a projection_dim
        # too, which CLIPTextModel does not build)
        self.projected = "CLIPTextModelWithProjection" in cfg.get("architectures", [])
        if self.projected:
            self.text_projection = M.Linear(cfg["hidden_size"], cfg["projection_dim"],
                                            bias=False)

    def forward(self, ids):
        tm = self.text_model
        s = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(
            torch.arange(s, device=ids.device))[None]
        mask = torch.triu(torch.full((s, s), float("-inf"), device=ids.device), diagonal=1)
        layers = tm.encoder.layers
        for layer in layers[:-1]:
            x = layer(x, mask)
        if not self.projected:
            return x, None
        last = tm.final_layer_norm(layers[-1](x, mask))
        pooled = last[torch.arange(last.shape[0], device=ids.device), ids.argmax(dim=-1)]
        return x, self.text_projection(pooled)


KINDS = ("unet", "text_encoder", "text_encoder_2", "vae")


def lora_targets(model: nn.Module, kind: str) -> List[tuple]:
    """(module name, in, out) of the reference's default LoRA targets of
    ``model``, sorted: every linear layer under a UNet attention or GEGLU,
    a tower's attention projections."""
    anc = (M.CrossAttention, M.GEGLU) if kind == "unet" else (M.CLIPAttention,)
    names = set()
    for aname, amod in model.named_modules():
        if isinstance(amod, anc):
            for name, m in amod.named_modules():
                if isinstance(m, nn.Linear):
                    names.add(f"{aname}.{name}")
    mods = dict(model.named_modules())
    return [(n, mods[n].in_features, mods[n].out_features) for n in sorted(names)]


def build(kind: str, cfg: dict) -> nn.Module:
    return {"unet": UNet, "text_encoder": CLIPTower, "text_encoder_2": CLIPTower,
            "vae": M.VAE}[kind](cfg)


class Schedule(_Schedule):
    """The SD schedule with the Euler grid's ``timestep_spacing`` and
    ``steps_offset`` from the scheduler config."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.timestep_spacing = cfg.get("timestep_spacing", "linspace")
        self.steps_offset = cfg.get("steps_offset", 0)


def condition(text_1, text_2, ids_1, ids_2):
    """(context [zeros; cond] (2B, 77, 2048), pooled [zeros; cond])."""
    h_1, _ = text_1(ids_1)
    h_2, pooled = text_2(ids_2)
    ctx = torch.cat([h_1, h_2], dim=-1)
    return torch.cat([torch.zeros_like(ctx), ctx]), torch.cat([torch.zeros_like(pooled), pooled])


def time_ids(b: int, height: int, width: int, device) -> torch.Tensor:
    row = torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32, device=device)
    return row.expand(2 * b, 6)


@torch.no_grad()
def txt2img(unet, text_1, text_2, vae, sched, sample, ids_1, ids_2, latents, guidance: float,
            steps: int, scaling_factor: float, vae_factor: int,
            mode: str = "fp32") -> torch.Tensor:
    """(B, H, W, 3) fp32 images in [0, 1] from (B, 4, h, w) initial latents,
    zeroed unconditioning; ``sample`` is a sampler's ``sample``.  Computed
    in ``mode`` (``numerics``): fp32 with ``torch.backends.cuda.matmul``'s
    and ``cudnn``'s ``allow_tf32`` False, or a control's rounding."""
    b, _, h, w = latents.shape
    with numerics.precision(mode):
        context, pooled = condition(text_1, text_2, ids_1, ids_2)
        tids = time_ids(b, h * vae_factor, w * vae_factor, latents.device)

        def eps(x, t):
            out = unet(torch.cat([x, x]), torch.full((2 * b,), t, device=x.device), context,
                       pooled, tids)
            eps_u, eps_c = out.chunk(2)
            return eps_u + guidance * (eps_c - eps_u)

        x = sample(eps, sched, latents.float(), steps)
        img = vae.decode(x / scaling_factor)
    return torch.clamp(img / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
