"""CLIP text encoder (port of the JAX ``models/clip_text.py``).

``transformers.CLIPTextModel`` state-dict names (``text_model.embeddings``,
``text_model.encoder.layers.<i>``, ``text_model.final_layer_norm``).  The
attention projections are :class:`~.layers.LoRALinear`, registered in the
k, v, q, out order of transformers' CLIPAttention (the JAX model's
:83-88), which :func:`text_encoder_lora_targets` enumerates.  The attention
itself stays plain torch with the fp32 causal mask (-3.4e38 above the
diagonal) and an fp32 softmax, as in the JAX package (:94-97, :156).

SDXL's two towers (``CLIPTextConfig.sdxl_l`` and ``sdxl_g``, which the JAX
package does not have) are read through ``forward(ids, penultimate=True)``:
the hidden state after the second-to-last layer, before
``final_layer_norm``, and with ``pooled=True`` (a projected tower,
``projection_dim``: transformers' ``CLIPTextModelWithProjection`` with its
bias-free ``text_projection``) the pooled embedding: the last layer's normed
state at the end-of-text position (the highest id, transformers' rule for
``eos_token_id`` 2), projected.  :data:`towers` counts the tower encodes
the Python calls ran.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from ..lora import LoraTarget
from .layers import ACT2FN, LoRALinear


# the token table's name in the text encoder's state dict
TOKEN_EMBEDDING = "text_model.embeddings.token_embedding.weight"

# tower encodes the Python calls ran (an SDXL prompt encode runs 2, an SD one
# 1); a replayed graph runs none
towers = 0


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    # the width of a projected tower's text_projection (transformers'
    # CLIPTextModelWithProjection); None: a plain CLIPTextModel
    projection_dim: Optional[int] = None

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        """openai/clip-vit-large-patch14 text config (SD 1.x)."""
        return CLIPTextConfig()

    @staticmethod
    def sd21() -> "CLIPTextConfig":
        """OpenCLIP ViT-H text config (SD 2.x): gelu, 23 layers."""
        return CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                              num_hidden_layers=23, num_attention_heads=16,
                              hidden_act="gelu")

    @staticmethod
    def sdxl_l() -> "CLIPTextConfig":
        """SDXL 1.0 base ``text_encoder``: CLIP ViT-L/14's tower."""
        return CLIPTextConfig()

    @staticmethod
    def sdxl_g() -> "CLIPTextConfig":
        """SDXL 1.0 base ``text_encoder_2``: OpenCLIP ViT-bigG/14, projected."""
        return CLIPTextConfig(hidden_size=1280, intermediate_size=5120,
                              num_hidden_layers=32, num_attention_heads=20,
                              hidden_act="gelu", projection_dim=1280)

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        """CPU-fast config for tests."""
        return CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64,
                              num_hidden_layers=2, num_attention_heads=4,
                              max_position_embeddings=77)


class CLIPAttention(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        h = config.hidden_size
        self.heads = config.num_attention_heads
        self.head_dim = h // self.heads
        self.k_proj = LoRALinear(h, h)
        self.v_proj = LoRALinear(h, h)
        self.q_proj = LoRALinear(h, h)
        self.out_proj = LoRALinear(h, h)

    def forward(self, x, causal_mask):
        # self.heads may be a tensor-parallel rank's share (parallel/tp.py)
        B, S, _ = x.shape
        d = self.head_dim
        split = lambda t: t.reshape(B, S, self.heads, d).transpose(1, 2)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        q = split(self.q_proj(x) * d ** -0.5)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) + causal_mask
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, S, self.heads * d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.act = ACT2FN[config.hidden_act]
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        eps = config.layer_norm_eps
        self.self_attn = CLIPAttention(config)
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=eps)
        self.mlp = CLIPMLP(config)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=eps)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position_embedding = nn.Embedding(config.max_position_embeddings,
                                               config.hidden_size)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        return self.token_embedding(input_ids) + self.position_embedding(pos)


class CLIPEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(config) for _ in range(config.num_hidden_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(config)
        self.encoder = CLIPEncoder(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """``forward(input_ids (B, S))`` -> last_hidden_state (B, S, hidden);
    ``penultimate`` and ``pooled`` for SDXL's reading of a tower."""

    lora_prefix = "text_model.encoder."

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(config.hidden_size, config.projection_dim,
                                             bias=False)

    def _layers(self, input_ids: torch.Tensor, n: int):
        """(the hidden state after the first ``n`` encoder layers, the
        causal mask)."""
        global towers
        towers += 1
        tm = self.text_model
        x = tm.embeddings(input_ids)
        S = input_ids.shape[1]
        mask = torch.triu(torch.full((S, S), -3.4e38, dtype=torch.float32,
                                     device=input_ids.device), diagonal=1)
        for layer in tm.encoder.layers[:n]:
            x = layer(x, mask)
        return x, mask

    def forward(self, input_ids: torch.Tensor, penultimate: bool = False,
                pooled: bool = False):
        """The last layer's normed state; with ``penultimate`` SDXL's
        reading: the hidden state after the second-to-last layer (no final
        norm), and with ``pooled`` also the projected pooled embedding (B,
        projection_dim), for which the last layer runs.  Without ``pooled``
        the last layer, whose output nothing reads, is not run."""
        n = self.config.num_hidden_layers
        if not penultimate:
            x, _ = self._layers(input_ids, n)
            return self.text_model.final_layer_norm(x)
        if not pooled:
            return self._layers(input_ids, n - 1)[0]
        if self.config.projection_dim is None:
            raise ValueError("a pooled embedding needs a projected tower (projection_dim)")
        x, mask = self._layers(input_ids, n - 1)
        last = self.text_model.final_layer_norm(self.text_model.encoder.layers[n - 1](x, mask))
        eos = input_ids.argmax(dim=-1)
        pooled_out = last[torch.arange(last.shape[0], device=last.device), eos]
        return x, self.text_projection(pooled_out)


def text_encoder_lora_targets(config: CLIPTextConfig) -> List[LoraTarget]:
    """Layer 0..N, within each layer k_proj, v_proj, q_proj, out_proj (the
    JAX package's order, models/clip_text.py:167)."""
    h = config.hidden_size
    return [LoraTarget((f"layers_{i}", "self_attn", proj), h, h, "CLIPAttention")
            for i in range(config.num_hidden_layers)
            for proj in ("k_proj", "v_proj", "q_proj", "out_proj")]


def resize_token_embeddings(params: Dict[str, torch.Tensor], new_size: int,
                            generator: Optional[torch.Generator] = None
                            ) -> Dict[str, torch.Tensor]:
    """Grow the token table of a text state dict (or of a dict of overrides
    holding it, :data:`TOKEN_EMBEDDING`) to ``new_size`` rows (JAX
    ``models/clip_text.py:187``; reference cli_lora_pti.py:70-107).  New
    rows are zeros, or N(0, 0.02) drawn from ``generator`` on its device in
    the table's dtype.  Returns a new dict (the same one if nothing grows)."""
    emb = params[TOKEN_EMBEDDING]
    old_size, dim = emb.shape
    if new_size <= old_size:
        return params
    shape = (new_size - old_size, dim)
    if generator is not None:
        new_rows = 0.02 * torch.randn(shape, generator=generator, device=generator.device,
                                      dtype=emb.dtype)
    else:
        new_rows = torch.zeros(shape, dtype=emb.dtype)
    return {**params, TOKEN_EMBEDDING: torch.cat([emb, new_rows.to(emb.device)])}
