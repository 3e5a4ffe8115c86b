"""Stable Diffusion XL txt2img on the port's generation path.

The JAX package has no SDXL; this pipe follows diffusers'
``StableDiffusionXLPipeline`` (SDXL 1.0 base) and runs on the same path as
:class:`~.pipeline.StableDiffusionPipeline`, which it extends: the same
``_generate`` (one CUDA graph a request key on the card), the same
channels-last scope, the same LoRA policy (merged or dynamic), the same
samplers and ``GenerationServer``.  What differs:

* **Two text towers.**  The UNet's context is the concatenation of the
  penultimate hidden states (before the final layer norm) of CLIP ViT-L
  (``text_encoder``, run through its second-to-last layer only: its last
  layer's output is never read) and OpenCLIP ViT-bigG (``text_encoder_2``),
  2048 wide; each tower has its tokenizer (``tokenizer``, ``tokenizer_2``).
* **Text-time conditioning.**  bigG's pooled, projected embedding and the
  time ids ``[height, width, 0, 0, height, width]`` (original size, crop
  top-left, target size) go to the UNet beside the context.
* **Zeroed unconditioning.**  A request whose negative prompts are all
  empty runs the towers on its prompts alone and gives the UNet zeros as
  the unconditional context and pooled embedding, as the published pipeline
  does with ``force_zeros_for_empty_prompt``.  Here an empty string counts
  as no negative prompt (the server's default); in a batch that mixes empty
  and written negative prompts, the empty rows' encodings are zeroed.
* **A third LoRA tree**, tower 2's (``text_encoder_2_lora``; a safetensors
  file's ``text_encoder_2`` pairs): generation params are the base pipe's
  four parts and tower 2's overrides and dynamic tree.
* The VAE decodes ``latents / vae_config.scaling_factor`` (0.13025), and
  the published scheduler is Euler with "leading" spacing
  (``SpacedSchedulerConfig``), the default here.

img2img, the trainers and ``shard_over`` refuse an SDXL pipe: they do not
give the UNet the added conditioning yet.  TI files extend tower 1's table
only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch.func import functional_call

from .. import lora as lora_lib
from ..data.tokenizer import CLIPTokenizer
from ..models import hf_loading
from ..models.clip_text import CLIPTextConfig, CLIPTextModel, text_encoder_lora_targets
from ..models.schedulers import SchedulerConfig, SpacedSchedulerConfig
from ..models.unet import UNetConfig
from ..models.vae import VAEConfig
from ..models.weights import load_module
from ..utils import profiling
from .pipeline import GenerationParams, LoRATree, StableDiffusionPipeline, _tree_to

# SDXL 1.0 base's scheduler/scheduler_config.json
SDXL_SCHEDULER = SpacedSchedulerConfig(timestep_spacing="leading")


def _tokenizer_2(tokenizer_dir: str) -> CLIPTokenizer:
    """Tower 2's tokenizer with the padding token its
    ``special_tokens_map.json`` names (SDXL's ``tokenizer_2`` pads with
    "!"); without the file, the end-of-text token pads.  Only this tokenizer
    reads the map: an SD 2.x directory also names "!", and the port pads SD's
    towers with end-of-text, as the JAX package does."""
    tok = CLIPTokenizer.from_pretrained(tokenizer_dir)
    special_path = os.path.join(tokenizer_dir, "special_tokens_map.json")
    if os.path.exists(special_path):
        with open(special_path) as f:
            pad = json.load(f).get("pad_token")
        pad = pad.get("content") if isinstance(pad, dict) else pad
        if pad in tok.encoder:
            tok.pad_token = pad
    return tok


class StableDiffusionXLPipeline(StableDiffusionPipeline):
    """:class:`StableDiffusionPipeline` with SDXL's second tower, added
    conditioning and zeroed unconditioning; ``text_encoder_2_lora`` is
    the installed tree of tower 2."""

    _text_time = True
    _towers = 2
    _lora_trees = StableDiffusionPipeline._lora_trees + (
        LoRATree("text_encoder_2_lora", "text_2", "text_encoder_2", "text_lora_2"),)

    def __init__(self, unet_config: UNetConfig, unet_params: Dict,
                 vae_config: VAEConfig, vae_params: Dict,
                 text_config: CLIPTextConfig, text_params: Dict, tokenizer: CLIPTokenizer,
                 text_config_2: CLIPTextConfig, text_params_2: Dict,
                 tokenizer_2: CLIPTokenizer,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        if not unet_config.text_time:
            raise ValueError("an SDXL pipe needs a UNet with addition_embed_type='text_time'")
        if text_config_2.projection_dim is None:
            raise ValueError("SDXL's second tower is a projected one (projection_dim)")
        width = text_config.hidden_size + text_config_2.hidden_size
        if width != unet_config.cross_attention_dim:
            raise ValueError(f"the towers' widths add up to {width}, the UNet's "
                             f"cross_attention_dim is {unet_config.cross_attention_dim}")
        super().__init__(unet_config, unet_params, vae_config, vae_params, text_config,
                         text_params, tokenizer, scheduler_config or SDXL_SCHEDULER,
                         dtype=dtype, device=device)
        self.text_config_2 = text_config_2
        self.text_encoder_2 = load_module(CLIPTextModel, text_config_2, text_params_2, dtype,
                                          self.device)
        self.tokenizer_2 = tokenizer_2
        self.text_encoder_2_lora: Optional[dict] = None

    def lora_targets(self, name: str, target_replace: set) -> list:
        if name == "text_encoder_2":
            return lora_lib.filter_targets(text_encoder_lora_targets(self.text_config_2),
                                           target_replace)
        return super().lora_targets(name, target_replace)

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype: torch.dtype = torch.float32,
                        params_dtype: Optional[torch.dtype] = None,
                        device="cuda") -> "StableDiffusionXLPipeline":
        """A pipe from a local diffusers SDXL directory: ``unet``, ``vae``,
        ``text_encoder``, ``text_encoder_2``, ``tokenizer``, ``tokenizer_2``
        and the optional ``scheduler/scheduler_config.json`` (its
        ``timestep_spacing`` included)."""
        comps = hf_loading.load_pipeline_components(model_dir)
        if "text_2_config" not in comps:
            raise ValueError(f"{model_dir} has no text_encoder_2: not an SDXL directory")
        sc = comps["scheduler_config"]
        sched = SpacedSchedulerConfig(
            num_train_timesteps=sc.get("num_train_timesteps", 1000),
            beta_start=sc.get("beta_start", 0.00085), beta_end=sc.get("beta_end", 0.012),
            beta_schedule=sc.get("beta_schedule", "scaled_linear"),
            prediction_type=sc.get("prediction_type", "epsilon"),
            steps_offset=sc.get("steps_offset", 1),
            set_alpha_to_one=sc.get("set_alpha_to_one", False),
            timestep_spacing=sc.get("timestep_spacing", "leading"))
        pipe = cls(comps["unet_config"], comps["unet_state_dict"],
                   comps["vae_config"], comps["vae_state_dict"],
                   comps["text_config"], comps["text_state_dict"],
                   CLIPTokenizer.from_pretrained(os.path.join(model_dir, "tokenizer")),
                   comps["text_2_config"], comps["text_2_state_dict"],
                   _tokenizer_2(os.path.join(model_dir, "tokenizer_2")),
                   sched, dtype=dtype, device=device)
        if params_dtype is not None:
            pipe.cast_params(params_dtype)
        return pipe

    def cast_params(self, params_dtype: torch.dtype) -> "StableDiffusionXLPipeline":
        with self._swap_lock:
            super().cast_params(params_dtype)
            self.text_encoder_2.to(params_dtype)
            if self.text_encoder_2_lora is not None:
                self.text_encoder_2_lora = _tree_to(self.text_encoder_2_lora, self.device,
                                                    params_dtype)
        return self

    def shard_over(self, mesh):
        raise NotImplementedError("SDXL generation over a mesh is not supported yet")

    def img2img(self, *args, **kwargs):
        raise NotImplementedError("SDXL img2img is not supported yet: it needs the "
                                  "text-time conditioning on the img2img path")

    # -- generation ---------------------------------------------------------
    @torch.inference_mode()
    def __call__(self, prompt: Union[str, Sequence[str]],
                 negative_prompt: Union[str, Sequence[str]] = "",
                 height: int = 1024, width: int = 1024, num_inference_steps: int = 50,
                 guidance_scale: float = 5.0, seed: Union[int, Sequence[int]] = 0,
                 scheduler: str = "euler", latents=None, output_type: str = "pil",
                 adapter_params: Optional[GenerationParams] = None, noise=None):
        """The base pipe's ``__call__`` at SDXL's defaults (1024², Euler,
        guidance 5)."""
        return super().__call__(prompt, negative_prompt, height, width, num_inference_steps,
                                guidance_scale, seed, scheduler, latents, output_type,
                                adapter_params, noise)

    def _text_inputs(self, negs, prompts, params, height: int, width: int):
        """Both tokenizers' ids of ``prompts`` (all negative prompts empty:
        the unconditional half is zeros) or of ``[negs; prompts]`` with the
        rows to keep of the unconditional half; the time ids of the
        ``2 B`` rows.  The key records which."""
        zeroed = all(n == "" for n in negs)
        texts = list(prompts) if zeroed else list(negs) + list(prompts)
        ids, ids_2 = self._token_ids(texts), self._token_ids_2(texts)
        self._check_ids_in_vocab(ids, params[2])
        rows = self.text_encoder_2.text_model.embeddings.token_embedding.num_embeddings
        if int(ids_2.max()) >= rows:
            raise ValueError(f"prompt tokenizes to id {int(ids_2.max())} in tokenizer_2, "
                             f"whose tower has {rows} rows")
        b = len(prompts)
        time_ids = np.tile(np.array([height, width, 0, 0, height, width], np.float32),
                           (2 * b, 1))
        out = {"ids": self._to_device(ids, torch.long),
               "ids_2": self._to_device(ids_2, torch.long),
               "time_ids": self._to_device(time_ids, torch.float32)}
        if not zeroed:
            out["keep"] = self._to_device(np.array([n != "" for n in negs], np.float32),
                                          torch.float32)
        return out, ("zeroed_uncond" if zeroed else "encoded_uncond",)

    def _token_ids_2(self, prompts: Sequence[str]) -> np.ndarray:
        tok = self.tokenizer_2
        return tok(list(prompts), padding="max_length", truncation=True,
                   max_length=tok.model_max_length, return_tensors="np")["input_ids"]

    def _condition(self, params, inputs):
        """(context (2B, 77, 2048), pooled (2B, 1280), time ids (2B, 6)):
        both towers' penultimate states side by side, tower 2's pooled
        projection; the unconditional half zeroed (or its empty rows)."""
        _, _, text_over, text_lora, over_2, text_lora_2 = params
        zeroed = "keep" not in inputs
        with profiling.span("pipe.condition", towers=2, rows=int(inputs["ids"].shape[0]),
                            zeroed_uncond=zeroed):
            with lora_lib.attached(self.text_encoder, text_lora):
                h_1 = functional_call(self.text_encoder, text_over, (inputs["ids"],),
                                      {"penultimate": True})
            with lora_lib.attached(self.text_encoder_2, text_lora_2):
                h_2, pooled = functional_call(self.text_encoder_2, over_2, (inputs["ids_2"],),
                                              {"penultimate": True, "pooled": True})
            context = torch.cat([h_1, h_2.to(h_1.dtype)], dim=-1)
            if zeroed:
                context = torch.cat([torch.zeros_like(context), context])
                pooled = torch.cat([torch.zeros_like(pooled), pooled])
            else:
                keep = inputs["keep"]
                scale = torch.cat([keep, torch.ones_like(keep)])
                context = context * scale.to(context.dtype)[:, None, None]
                pooled = pooled * scale.to(pooled.dtype)[:, None]
        return context, pooled, inputs["time_ids"]

    @torch.inference_mode()
    def encode_prompt(self, prompts: Sequence[str]):
        """(context, pooled) of ``prompts`` under the installed trees: both
        towers' penultimate states side by side and tower 2's pooled
        projection."""
        params = self._generation_params()
        n = len(prompts)
        text, _ = self._text_inputs([""] * n, prompts, params, 0, 0)
        context, pooled, _ = self._condition(params, text)
        return context[n:], pooled[n:]
