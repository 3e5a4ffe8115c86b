"""Stable Diffusion txt2img and img2img pipeline (port of the JAX
``pipelines/pipeline.py``), with its LoRA and TI entry points.

``__call__`` is the serving path: CLIP encode of the CFG pair
``[uncond; cond]``, a denoise loop whose every step runs the UNet once on
the doubled batch and mixes ``eps = eps_u + g * (eps_c - eps_u)``, VAE
decode of ``latents / 0.18215``, then ``clip(x / 2 + 0.5)``, ``round(x *
255)`` and uint8.  The loop's sampler is any of the JAX pipeline's (:575-680):
DDIM (the default), PNDM, DPM-Solver++(2M), and Euler, Euler-ancestral or
LMS in sigma space (latents scaled by ``init_noise_sigma``, the UNet fed
``scale_model_input``; ``:karras`` for the rho-7 grid).
:meth:`~StableDiffusionPipeline.img2img` (JAX :945, ``_build_img2img_fn``
:808) starts any of those samplers part-way: VAE encode of the init image, a
posterior sample times 0.18215 for every prompt, forward noising to the
first used timestep (sigma-space samplers: to its sigma), then the sampler
restarted on the grid's tail (``schedulers.restart_on_tail``).  On the card the
UNet's attention calls go through the flash-attention kernels, with a
dynamic LoRA its LoRA projections through the fused LoRA kernel, and with
``DFT_CONV_PALLAS`` its resnet 3x3 convs through the fused conv.

On the card a whole request -- text encode, the denoise loop, VAE decode
and uint8 (img2img: also the VAE encode and the forward noising) -- is one
CUDA graph (``graph.py``), as the JAX pipeline jits one executable per key
(``_cached`` :303, ``_build_denoise_fn`` :567, ``_build_img2img_fn`` :808).
LoRA trees are arguments of the graph, as they are of the JAX executable
(:10-13): a graph reads its LoRA-dependent tensors -- the merged weights,
or the dynamic LoRA leaves, and the text overrides with a TI-grown token
table -- from static buffers the pipeline's ``Graphs`` owns, one set per
shape signature (``graph.ParamBuffers``); before a replay whatever the
request's trees changed is copied in on its stream, so a swapped or
retuned LoRA replays the same graph.  The key: the request kind, steps
(and img2img's first step), height, width, scheduler, batch; the scheduler
config; the signature (which LoRA sets and overrides are present, merged or
dynamic, their names, ranks and shapes, the token table's rows); the two
kernel switches.  The first request of a key captures its graph, later
ones copy their inputs into its static buffers and replay it: the token
ids (from pinned host memory), the initial latents and Euler-ancestral's
per-step noise (drawn per seed on the device), img2img's init image and
draws (Euler-ancestral's noise among them), and the guidance scale, a 0-d
device tensor.  ``cuda_graphs =
False`` runs requests eagerly on the card, the reference the graphs are
held against; on the CPU they always run eagerly.

LoRA serving follows the JAX pipeline's policy (:154-165, :410-508): with
``materialize_lora`` (the default) a tree is folded into the weights
(``lora.materialize_lora_tree``) once, and generation runs the merged
weights; with it off, the tree is attached to the LoRA layers for the call
(the dynamic path).  The installed trees (``unet_lora``,
``text_encoder_lora``) keep one merged set each, dropped when a new tree is
installed; explicit adapters (:meth:`adapter_generation_params`, the
server's per-request trees) an LRU of :data:`MERGED_LORA_CACHE_SIZE`.
Trees are swapped, never edited in place (``tune_lora_scale`` returns a
new tree); call :meth:`invalidate_merged_cache` after an in-place edit.

The text encoder's weights live in its module; ``text_params`` holds the
overrides a TI file makes (the grown token table under
``clip_text.TOKEN_EMBEDDING``), where the JAX pipeline holds the whole
text parameter tree.  Public layouts are the JAX package's: ``latents``
(B, h, w, 4), images (B, H, W, 3), img2img's init image (H, W, 3).  The
model modules run NCHW.  Multi-device sharding (``shard_over``) comes in a
later slice.
"""

from __future__ import annotations

import collections
import gc
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from .. import lora as lora_lib
from .. import resolve_device
from ..data.tokenizer import CLIPTokenizer
from ..graph import Graphs
from ..models import hf_loading
from ..models.clip_text import (TOKEN_EMBEDDING, CLIPTextConfig, CLIPTextModel,
                                resize_token_embeddings, text_encoder_lora_targets)
from ..models.layers import kernel_switches
from ..models.schedulers import (DDIMScheduler, DDPMScheduler, EulerDiscreteScheduler,
                                 SchedulerConfig, img2img_scheduler, restart_on_tail,
                                 txt2img_scheduler)
from ..models.unet import UNet2DConditionModel, UNetConfig, unet_all_lora_targets
from ..models.vae import SCALING_FACTOR, AutoencoderKL, VAEConfig
from ..models.weights import load_module

# merged LoRA sets kept for explicit adapters (the server's per-request
# trees), least recently used dropped first: the JAX pipeline's bound (:51-54)
MERGED_LORA_CACHE_SIZE = max(1, int(os.environ.get("DFT_MERGED_LORA_CACHE", "8")))

# (unet overrides, unet LoRA tree, text overrides, text LoRA tree)
GenerationParams = Tuple[Dict[str, torch.Tensor], Optional[Dict], Dict[str, torch.Tensor],
                         Optional[Dict]]


def img2img_start(num_steps: int, strength: float) -> int:
    """The first grid step img2img runs (JAX :999): strength 1 starts from
    the top, strength 0 still runs the last step."""
    return int(min(num_steps - 1, round((1 - strength) * num_steps)))


def apply_learned_embed_in_clip(learned_embeds: Dict[str, Any], text_params: Dict[str, torch.Tensor],
                                tokenizer: CLIPTokenizer,
                                token: Optional[Union[str, List[str]]] = None,
                                idempotent: bool = False
                                ) -> Tuple[Dict[str, torch.Tensor], Union[str, List[str]]]:
    """Add TI tokens to ``tokenizer`` and write their rows into the token
    table of ``text_params`` (a text state dict, or overrides, holding
    :data:`~..models.clip_text.TOKEN_EMBEDDING`), grown to the vocabulary
    with zero rows.  With ``idempotent`` off a token the tokenizer has is
    renamed ``token[:-1]-i>`` until it is new (reference lora.py:613-656).
    Returns (new text params, the final token names); the input dict and
    its table are left as they were."""
    if isinstance(token, str):
        trained_tokens = [token]
    elif isinstance(token, list):
        if len(learned_embeds) != len(token):
            raise ValueError("The number of tokens and the number of embeds should be the same")
        trained_tokens = token
    else:
        trained_tokens = list(learned_embeds.keys())

    final_tokens = []
    for tok, embeds in zip(trained_tokens, [learned_embeds[t] for t in trained_tokens]):
        num_added = tokenizer.add_tokens(tok)
        i = 1
        if not idempotent:
            while num_added == 0:
                print(f"The tokenizer already contains the token {tok}.")
                tok = f"{tok[:-1]}-{i}>"
                print(f"Attempting to add the token {tok}.")
                num_added = tokenizer.add_tokens(tok)
                i += 1
        elif num_added == 0:
            print(f"The tokenizer already contains the token {tok}.")
            print(f"Replacing {tok} embedding.")

        grown = resize_token_embeddings(text_params, len(tokenizer))
        emb = grown[TOKEN_EMBEDDING]
        if emb is text_params[TOKEN_EMBEDDING]:
            emb = emb.clone()
        emb[tokenizer.convert_tokens_to_ids(tok)] = torch.as_tensor(embeds).to(
            emb.device, torch.float32).to(emb.dtype)
        text_params = {**text_params, TOKEN_EMBEDDING: emb}
        final_tokens.append(tok)
    return text_params, (final_tokens[0] if len(final_tokens) == 1 else final_tokens)


def load_learned_embed_in_clip(learned_embeds_path: str, text_params: Dict[str, torch.Tensor],
                               tokenizer: CLIPTokenizer,
                               token: Optional[Union[str, List[str]]] = None,
                               idempotent: bool = False):
    """:func:`apply_learned_embed_in_clip` with the embeds of a ``.pt``
    file (a dict token -> tensor)."""
    learned = torch.load(learned_embeds_path, map_location="cpu", weights_only=True)
    return apply_learned_embed_in_clip(learned, text_params, tokenizer, token, idempotent)


def _leaves(tree, prefix=()):
    """(path, tensor) of a nested dict's leaves, in insertion order."""
    for k, v in (tree or {}).items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flatten(params: GenerationParams) -> Dict[Tuple, torch.Tensor]:
    return {(i,) + path: t for i, part in enumerate(params) for path, t in _leaves(part)}


def param_signature(params: GenerationParams):
    """(signature, flat params): the flat {(part, *path): tensor} of a
    generation-params tuple and what fixes a graph's code path and its
    buffers -- every name, shape and dtype (which sets are present, merged
    or dynamic, the ranks and targets, the token table's rows)."""
    flat = _flatten(params)
    return tuple((k, tuple(flat[k].shape), flat[k].dtype) for k in sorted(flat)), flat


def _unflatten(flat: Dict[Tuple, torch.Tensor]) -> GenerationParams:
    parts: List[Dict] = [{}, {}, {}, {}]
    for (i, *path), t in flat.items():
        node = parts[i]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tuple(parts)


class StableDiffusionPipeline:
    """Bundles the UNet, VAE and CLIP modules, the tokenizer and the
    scheduler config, plus the installed LoRA trees ``unet_lora`` /
    ``text_encoder_lora`` (JAX-path-addressed, see ``lora.py``) and text
    overrides ``text_params``."""

    def __init__(self, unet_config: UNetConfig, unet_params: Dict,
                 vae_config: VAEConfig, vae_params: Dict,
                 text_config: CLIPTextConfig, text_params: Dict,
                 tokenizer: CLIPTokenizer,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.unet_config, self.vae_config, self.text_config = unet_config, vae_config, text_config
        self.unet = load_module(UNet2DConditionModel, unet_config, unet_params, dtype,
                                self.device)
        self.vae = load_module(AutoencoderKL, vae_config, vae_params, dtype, self.device)
        self.text_encoder = load_module(CLIPTextModel, text_config, text_params, dtype,
                                        self.device)
        self.tokenizer = tokenizer
        self.scheduler_config = scheduler_config or SchedulerConfig()
        self.unet_lora: Optional[dict] = None
        self.text_encoder_lora: Optional[dict] = None
        # text-encoder weights that differ from the module's: a TI file's
        # grown token table (JAX keeps the whole tree as text_params)
        self.text_params: Dict[str, torch.Tensor] = {}
        # fold LoRA deltas into the weights for generation (JAX :154-165);
        # False runs the dynamic path through the LoRA kernel
        self.materialize_lora: bool = True
        # whole requests through CUDA graphs on the card; False runs them
        # eagerly there (the graphs' reference)
        self.cuda_graphs: bool = True
        self._merged_current: Dict[Tuple, Tuple] = {}
        self._merged_cache: "collections.OrderedDict[Tuple, Tuple]" = collections.OrderedDict()
        # serialises LoRA/TI swaps, merges, captures and replays: a request
        # sees one consistent tree set, and no device work from another
        # thread runs inside a capture (JAX :172-177)
        self._swap_lock = threading.RLock()
        self._graphs: Optional[Graphs] = None
        # forward-noising schedulers by config; never dropped, since a
        # captured img2img graph reads its device table
        self._ddpm: Dict[SchedulerConfig, DDPMScheduler] = {}

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.vae_config.block_out_channels) - 1)

    def lora_targets(self, name: str, target_replace: set) -> list:
        if name == "unet":
            return lora_lib.filter_targets(unet_all_lora_targets(self.unet_config),
                                           target_replace)
        if name == "text_encoder":
            return lora_lib.filter_targets(text_encoder_lora_targets(self.text_config),
                                           target_replace)
        raise KeyError(name)

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype: torch.dtype = torch.float32,
                        params_dtype: Optional[torch.dtype] = None,
                        device="cuda") -> "StableDiffusionPipeline":
        """A pipeline from a local diffusers directory (JAX :260):
        ``unet``, ``vae``, ``text_encoder``, ``tokenizer`` and the optional
        ``scheduler/scheduler_config.json``.  ``params_dtype``: see
        :meth:`cast_params`."""
        comps = hf_loading.load_pipeline_components(model_dir)
        tokenizer = CLIPTokenizer.from_pretrained(os.path.join(model_dir, "tokenizer"))
        sc = comps["scheduler_config"]
        sched = SchedulerConfig(
            num_train_timesteps=sc.get("num_train_timesteps", 1000),
            beta_start=sc.get("beta_start", 0.00085),
            beta_end=sc.get("beta_end", 0.012),
            beta_schedule=sc.get("beta_schedule", "scaled_linear"),
            prediction_type=sc.get("prediction_type", "epsilon"),
            steps_offset=sc.get("steps_offset", 1),
            set_alpha_to_one=sc.get("set_alpha_to_one", False),
        )
        pipe = cls(comps["unet_config"], comps["unet_state_dict"],
                   comps["vae_config"], comps["vae_state_dict"],
                   comps["text_config"], comps["text_state_dict"],
                   tokenizer, sched, dtype=dtype, device=device)
        if params_dtype is not None:
            pipe.cast_params(params_dtype)
        return pipe

    def cast_params(self, params_dtype: torch.dtype) -> "StableDiffusionPipeline":
        """Cast the stored weights, the text overrides and the installed
        LoRA trees (their scales stay fp32) to ``params_dtype`` (JAX :213).
        The port's modules compute in their weights' dtype, so this sets the
        compute dtype too.  Merged sets and graphs, which read the old
        weights, are dropped.  Returns self."""
        with self._swap_lock:
            for m in (self.unet, self.vae, self.text_encoder):
                m.to(params_dtype)
            self.dtype = params_dtype
            self.text_params = {k: v.to(params_dtype) for k, v in self.text_params.items()}
            for attr in ("unet_lora", "text_encoder_lora"):
                tree = getattr(self, attr)
                if tree is not None:
                    setattr(self, attr, _tree_to(tree, self.device, params_dtype))
            self._merged_current.clear()
            self._merged_cache.clear()
            self._graphs = None
        return self

    def release_graphs(self) -> None:
        """Drop the request graphs and their memory pool (a trainer that has
        synthesised its class images needs the memory for training); the
        next request captures afresh."""
        with self._swap_lock:
            self._graphs = None
        if self.device.type == "cuda":
            gc.collect()
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- LoRA materialization ----------------------------------------------
    def invalidate_merged_cache(self) -> None:
        """Drop the merged weights, and make the graphs' static buffers copy
        afresh at the next replay: call after an in-place edit of a tree."""
        with self._swap_lock:
            self._merged_current.clear()
            self._merged_cache.clear()
            if self._graphs is not None:
                for bufs in self._graphs.params.values():
                    bufs.forget()

    def _merged(self, which: str, lora, dynamic: bool, installed: bool):
        """Merged weights for ``lora`` (``dynamic``: the tree itself on the
        model's device and dtype).  An installed tree has one slot per
        ``which``, dropped before its successor is built; an explicit
        adapter's goes into the LRU.  Both are found again by the tree's
        identity (the entry holds the tree).  They are built outside
        inference mode, as ordinary tensors that need no grad, so that
        per-weight caches keyed on a tensor's version (the fused conv's
        tap-major copy, ``ops/conv3x3.py:tap_major``) can hold them."""
        slot = (which, dynamic) if installed else (which, dynamic, id(lora))
        cache = self._merged_current if installed else self._merged_cache
        hit = cache.pop(slot, None)
        if hit is not None and hit[0] is lora:
            cache[slot] = hit  # back at the LRU's young end
            return hit[1]
        # the superseded set and the LRU's eldest are freed before the
        # successor is built: a swap never holds two merged sets
        del hit
        if not installed:
            while len(self._merged_cache) >= MERGED_LORA_CACHE_SIZE:
                self._merged_cache.popitem(last=False)
        model = self.unet if which == "unet" else self.text_encoder
        w = next(model.parameters())
        with torch.inference_mode(False), torch.no_grad():
            out = (_tree_to(lora, w.device, w.dtype) if dynamic
                   else lora_lib.materialize_lora_tree(model, lora))
        cache[slot] = (lora, out)
        return out

    def _resolve(self, unet_lora, text_lora, text_params, materialize: bool,
                 installed: bool) -> GenerationParams:
        unet_over: Dict[str, torch.Tensor] = {}
        text_over = dict(text_params)
        if unet_lora is not None:
            unet_lora = self._merged("unet", unet_lora, not materialize, installed)
            if materialize:
                unet_over, unet_lora = unet_lora, None
        if text_lora is not None:
            text_lora = self._merged("text", text_lora, not materialize, installed)
            if materialize:
                text_over.update(text_lora)
                text_lora = None
        return unet_over, unet_lora, text_over, text_lora

    def _generation_params(self) -> GenerationParams:
        """(unet overrides, unet LoRA, text overrides, text LoRA) of the
        installed trees under the materialization policy, read as one
        consistent set."""
        with self._swap_lock:
            return self._resolve(self.unet_lora, self.text_encoder_lora, self.text_params,
                                 self.materialize_lora, installed=True)

    def adapter_generation_params(self, unet_lora=None, text_lora=None, text_params=None,
                                  materialize: Optional[bool] = None) -> GenerationParams:
        """The generation params of an explicit adapter tree set, installing
        nothing (JAX :470): what ``GenerationServer`` resolves per batch and
        passes as ``__call__(..., adapter_params=...)``.  ``text_params``
        defaults to the pipe's; ``materialize`` to ``materialize_lora``.
        Merged sets go into the LRU."""
        with self._swap_lock:
            mat = self.materialize_lora if materialize is None else materialize
            return self._resolve(unet_lora, text_lora,
                                 self.text_params if text_params is None else text_params,
                                 mat, installed=False)

    def _generate(self, key: tuple, body, inputs: Dict[str, torch.Tensor],
                  params: GenerationParams) -> torch.Tensor:
        """``body(params, inputs)`` -> uint8 images.  On the card (unless
        ``cuda_graphs`` is off) through the CUDA graph of ``key`` and of
        ``params``' signature: the params are copied into (or are already
        in) the signature's static buffers, then the graph is captured by
        the key's first request and replayed, with the new inputs copied
        into its static buffers, by later ones."""
        if self.device.type != "cuda" or not self.cuda_graphs:
            return body(params, inputs)
        with self._swap_lock:  # one request at a time through the buffers
            sig, flat = param_signature(params)
            key = key + (self.scheduler_config, sig, kernel_switches())
            if self._graphs is None:
                self._graphs = Graphs(self.device)
            static_params = _unflatten(self._graphs.param_buffers(sig, flat))
            return self._graphs.run(key, lambda static: body(static_params, static), inputs,
                                    signature=sig).clone()

    # -- text encoding ------------------------------------------------------
    def _token_ids(self, prompts: Sequence[str]) -> np.ndarray:
        return self.tokenizer(list(prompts), padding="max_length", truncation=True,
                              max_length=self.tokenizer.model_max_length,
                              return_tensors="np")["input_ids"]

    def _check_ids_in_vocab(self, ids: np.ndarray, text_over: Dict[str, torch.Tensor]) -> None:
        """Token ids must index inside the token table in use: the override
        of the request's tree set, else the module's (JAX :532).  The
        tokenizer is shared and grows with every TI load, while each tree
        set keeps the table it was built with."""
        table = text_over.get(TOKEN_EMBEDDING)
        rows = (table.shape[0] if table is not None
                else self.text_encoder.text_model.embeddings.token_embedding.num_embeddings)
        mx = int(ids.max())
        if mx >= rows:
            raise ValueError(
                f"prompt tokenizes to id {mx} but the selected text-encoder embedding table "
                f"has only {rows} rows — the token was added to the shared vocabulary after "
                "this adapter/pipe tree was built. Re-register the adapter (or re-run "
                "patch_pipe) so its embedding table covers the token, or drop the token "
                "from the prompt.")

    def _to_device(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """A host array on the pipe's device; to the card from pinned memory,
        so the copy neither waits for the stream's earlier work nor, in a
        graph's buffer refill, reads pageable memory."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _encode(self, ids, text_over, text_lora) -> torch.Tensor:
        with lora_lib.attached(self.text_encoder, text_lora):
            return functional_call(self.text_encoder, text_over, (ids,))

    @torch.inference_mode()
    def encode_prompt(self, prompts: Sequence[str]) -> torch.Tensor:
        _, _, text_over, text_lora = self._generation_params()
        ids = self._token_ids(prompts)
        self._check_ids_in_vocab(ids, text_over)
        return self._encode(self._to_device(ids, torch.long), text_over, text_lora)

    # -- generation ---------------------------------------------------------
    def _initial_latents(self, b, height, width, latents, seed, noise_steps: int = 0):
        """(latents (B, C, h, w), per-step noise (steps, B, C, h, w) or
        None).  Each seed's generator draws its latents, then its
        ``noise_steps`` noise draws, so neither depends on the batch; given
        ``latents`` replace the first draw."""
        f = self.vae_scale_factor
        if height % f or width % f or height < f or width < f:
            raise ValueError(f"height and width ({height}x{width}) must be positive "
                             f"multiples of the VAE's factor {f}")
        shape = (self.unet_config.in_channels, height // f, width // f)
        given = None
        if latents is not None:
            lat = latents if isinstance(latents, torch.Tensor) else torch.from_numpy(
                np.asarray(latents, np.float32))
            given = lat.to(self.device, torch.float32).permute(0, 3, 1, 2).contiguous()
            if tuple(given.shape) != (b,) + shape:
                raise ValueError(f"latents {tuple(given.shape)} != {(b,) + shape} (NCHW)")
            if not noise_steps:
                return given, None
        seeds = [seed + i for i in range(b)] if isinstance(seed, int) else list(seed)
        if len(seeds) != b:
            raise ValueError("one seed per prompt")
        lats, noises = [], []
        for s in seeds:
            g = torch.Generator(device=self.device).manual_seed(int(s))
            lats.append(torch.randn(shape, generator=g, device=self.device))
            if noise_steps:
                noises.append(torch.randn((noise_steps,) + shape, generator=g,
                                          device=self.device))
        noise = torch.stack(noises, dim=1) if noise_steps else None
        return (torch.stack(lats) if given is None else given), noise

    @torch.inference_mode()
    def __call__(self, prompt: Union[str, Sequence[str]],
                 negative_prompt: Union[str, Sequence[str]] = "",
                 height: int = 512, width: int = 512, num_inference_steps: int = 50,
                 guidance_scale: float = 7.5, seed: Union[int, Sequence[int]] = 0,
                 scheduler: str = "ddim", latents=None, output_type: str = "pil",
                 adapter_params: Optional[GenerationParams] = None, noise=None):
        """``seed`` may be one int (element i gets ``seed + i``) or one per
        prompt; ``latents`` (B, h, w, 4) overrides the seeds' latents and
        ``noise`` (steps, B, h, w, 4) Euler-ancestral's per-step noise.
        ``adapter_params`` (from :meth:`adapter_generation_params`) generates
        with that tree set instead of the installed one.  ``output_type``:
        "pil", "np" (floats in [0, 1]), "device" (the uint8 tensor where it
        is, no host sync) or anything else for the uint8 array."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        negs = ([negative_prompt] * len(prompts) if isinstance(negative_prompt, str)
                else list(negative_prompt))
        b = len(prompts)
        if len(negs) != b:
            raise ValueError(f"{len(negs)} negative prompts for {b} prompts — pass one "
                             "string (broadcast) or a list of matching length")
        sch = txt2img_scheduler(scheduler, self.scheduler_config)
        ancestral = getattr(sch, "stochastic", False)
        steps = num_inference_steps
        params = (adapter_params if adapter_params is not None
                  else self._generation_params())
        ids = self._token_ids(negs + prompts)
        self._check_ids_in_vocab(ids, params[2])
        x, drawn = self._initial_latents(b, height, width, latents, seed,
                                         steps if ancestral and noise is None else 0)
        inputs = {"ids": self._to_device(ids, torch.long), "latents": x,
                  "guidance": self._guidance(guidance_scale)}
        if ancestral:
            if noise is not None:
                n = noise if isinstance(noise, torch.Tensor) else torch.from_numpy(
                    np.asarray(noise, np.float32))
                drawn = n.to(self.device, torch.float32).permute(0, 1, 4, 2, 3).contiguous()
                if tuple(drawn.shape) != (steps,) + tuple(x.shape):
                    raise ValueError(f"noise {tuple(drawn.shape)} != {(steps,) + tuple(x.shape)}")
            inputs["noise"] = drawn
        images = self._generate(
            ("txt2img", steps, height, width, scheduler, b),
            lambda p, inp: self._txt2img(p, inp, steps, scheduler), inputs, params)
        return self._postprocess(images, output_type)

    def _guidance(self, scale: float) -> torch.Tensor:
        return torch.full((), scale, dtype=torch.float32, device=self.device)

    def _txt2img(self, params, inputs, num_steps: int, scheduler: str) -> torch.Tensor:
        unet_over, unet_lora, text_over, text_lora = params
        context = self._encode(inputs["ids"], text_over, text_lora)
        sch = txt2img_scheduler(scheduler, self.scheduler_config)
        x, state = inputs["latents"], None
        if isinstance(sch, EulerDiscreteScheduler):  # sigma space
            x = x * sch.init_noise_sigma(num_steps)
            state = sch.init_state(x, num_steps, noise=inputs.get("noise"))
        elif not isinstance(sch, DDIMScheduler):
            state = sch.init_state(x, num_steps)
        x = self._denoise(x, sch, sch.timesteps(num_steps).tolist(), num_steps, context,
                          unet_over, unet_lora, inputs["guidance"], state)
        return self._decode(x)

    def _denoise(self, x, sch, timesteps, num_steps, context, unet_over, unet_lora, g,
                 state=None):
        """The CFG loop over ``timesteps``: the UNet on [x; x] (sigma-space
        samplers: on their scaled input, at float timesteps) against
        ``context`` ([uncond; cond]), eps_u + g (eps_c - eps_u) in fp32 (``g``
        a 0-d fp32 device tensor), a ``sch.step`` each; ``state`` carries a
        stateful sampler's counter and history (None: DDIM)."""
        b = x.shape[0]
        sigma = isinstance(sch, EulerDiscreteScheduler)
        with lora_lib.attached(self.unet, unet_lora):
            for t in timesteps:
                xin = sch.scale_model_input(x, state, num_steps) if sigma else x
                x2 = torch.cat([xin, xin])
                t2 = torch.full((2 * b,), t, dtype=torch.float32 if sigma else torch.long,
                                device=self.device)
                eps = functional_call(self.unet, unet_over, (x2, t2, context))
                eps_u, eps_c = eps.chunk(2)
                eps = eps_u.float() + g * (eps_c - eps_u).float()
                if state is None:
                    x = sch.step(eps, t, x, num_steps)
                else:
                    x, state = sch.step(eps, t, x, state, num_steps)
        return x

    def _decode(self, x) -> torch.Tensor:
        """Latents -> uint8 (B, H, W, 3) on the device."""
        images = self.vae.decode(x / SCALING_FACTOR).float()
        images = torch.clamp(images / 2 + 0.5, 0.0, 1.0)
        return torch.round(images * 255.0).to(torch.uint8).permute(0, 2, 3, 1)

    def img2img_draws(self, seed: int, batch: int, latent_hw: Tuple[int, int],
                      noise_steps: int = 0) -> Dict:
        """img2img's draws from one seeded generator on the device, in the
        latents' (B, h, w, C) layout: ``sample``, the posterior sample's
        noise for the one init image (1, h, w, C); ``noise``, the forward
        noising's, one per prompt (batch, h, w, C); with ``noise_steps``,
        ``ancestral``, Euler-ancestral's per-step noise (noise_steps, batch,
        h, w, C).  The JAX pipeline draws them from ``PRNGKey(seed)`` (the
        ancestral noise from ``fold_in(key, 7)``), which torch cannot
        reproduce; the parity tests hand JAX's draws to :meth:`img2img`."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        c = self.unet_config.in_channels
        out = {"sample": torch.randn((1, *latent_hw, c), generator=gen, device=self.device),
               "noise": torch.randn((batch, *latent_hw, c), generator=gen, device=self.device)}
        if noise_steps:
            out["ancestral"] = torch.randn((noise_steps, batch, *latent_hw, c), generator=gen,
                                           device=self.device)
        return out

    @torch.inference_mode()
    def img2img(self, prompt: Union[str, Sequence[str]], init_image,
                strength: float = 0.75, negative_prompt: Union[str, Sequence[str]] = "",
                num_inference_steps: int = 50, guidance_scale: float = 7.5, seed: int = 0,
                scheduler: str = "ddim", output_type: str = "pil", draws=None,
                adapter_params: Optional[GenerationParams] = None):
        """SDEdit-style img2img (JAX :945-1031, the reference
        ``scripts/run_img2img.ipynb`` flow).

        ``init_image`` (H, W, 3), uint8 or floats in [0, 1], is mapped to
        [-1, 1] and encoded; one posterior sample times 0.18215 serves every
        prompt, each with its own forward noise to ``ts[t_start]`` of the
        sampler's grid ``ts``, where ``t_start = min(len(ts) - 1, round((1 -
        strength) * len(ts)))`` (Python's half-to-even ``round``: strength
        0.75 at 50 DDIM steps starts at step 12 and runs 38); the CFG loop
        then runs ``ts[t_start:]``.  ``scheduler``: ddim, pndm, dpm, or
        euler / euler_a / lms with an optional ``:karras`` (see
        ``schedulers.img2img_scheduler``); the sigma-space ones noise the
        latents to their start sigma instead.  ``draws`` (see
        :meth:`img2img_draws`; with ``ancestral`` for euler_a) replaces the
        seeded draws; ``adapter_params``: see ``__call__``."""
        # a bad name or variant raises JAX's error (:985-992) before any work
        sch = img2img_scheduler(scheduler, self.scheduler_config)
        ancestral = getattr(sch, "stochastic", False)
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        negs = ([negative_prompt] * len(prompts) if isinstance(negative_prompt, str)
                else list(negative_prompt))
        b = len(prompts)
        if len(negs) != b:
            raise ValueError(f"{len(negs)} negative prompts for {b} prompts")
        img = np.asarray(init_image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        x = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        x = (x * 2.0 - 1.0).permute(2, 0, 1)[None]  # (1, 3, H, W) in [-1, 1]
        h, w, f = x.shape[2], x.shape[3], self.vae_scale_factor
        if h % f or w % f:
            raise ValueError(f"init image {h}x{w} is not a multiple of the VAE's factor {f}")

        ts = sch.timesteps(num_inference_steps).tolist()  # the whole grid
        t_start = img2img_start(len(ts), strength)
        used = len(ts) - t_start
        sch = restart_on_tail(sch, num_inference_steps, t_start)
        if draws is None:
            draws = self.img2img_draws(seed, b, (h // f, w // f), used if ancestral else 0)

        def draw(key, shape):
            d = draws[key]
            d = d if isinstance(d, torch.Tensor) else torch.from_numpy(np.array(d, np.float32))
            if tuple(d.shape) != shape:
                raise ValueError(f"draws[{key!r}] {tuple(d.shape)} != {shape} (NHWC)")
            d = d.to(self.device, torch.float32)
            return d.permute(0, 3, 1, 2) if d.ndim == 4 else d.permute(0, 1, 4, 2, 3)

        c = self.unet_config.in_channels
        params = (adapter_params if adapter_params is not None
                  else self._generation_params())
        ids = self._token_ids(negs + prompts)
        self._check_ids_in_vocab(ids, params[2])
        inputs = {"ids": self._to_device(ids, torch.long), "image": x,
                  "sample": draw("sample", (1, h // f, w // f, c)),
                  "noise": draw("noise", (b, h // f, w // f, c)),
                  "guidance": self._guidance(guidance_scale)}
        if ancestral:
            if "ancestral" not in draws:
                raise ValueError(f"{scheduler} img2img needs draws['ancestral']")
            inputs["ancestral"] = draw("ancestral", (used, b, h // f, w // f, c))
        images = self._generate(
            ("img2img", num_inference_steps, t_start, h, w, scheduler, b),
            lambda p, inp: self._img2img(p, inp, num_inference_steps, sch, ts[t_start:]),
            inputs, params)
        return self._postprocess(images, output_type)

    def _img2img(self, params, inputs, num_steps: int, sch, ts_used) -> torch.Tensor:
        """The whole request from its device inputs; ``sch`` is the sampler
        restarted on its grid's tail ``ts_used``, stateless between calls
        (its state lives in the loop), so a capture and its warm-up share it."""
        unet_over, unet_lora, text_over, text_lora = params
        context = self._encode(inputs["ids"], text_over, text_lora)
        post = self.vae.encode(inputs["image"])
        latents0 = (post.sample(noise=inputs["sample"]) * SCALING_FACTOR).repeat(
            inputs["noise"].shape[0], 1, 1, 1).float()
        cfg = self.scheduler_config
        state = None
        if isinstance(sch, EulerDiscreteScheduler):  # VE forward noising to the start sigma
            x = latents0 + sch.init_noise_sigma(num_steps) * inputs["noise"]
            state = sch.init_state(x, num_steps, noise=inputs.get("ancestral"))
        else:
            ddpm = self._ddpm.get(cfg)
            if ddpm is None:
                ddpm = self._ddpm[cfg] = DDPMScheduler(cfg)
            t0 = torch.full((1,), ts_used[0], dtype=torch.long, device=self.device)
            x = ddpm.add_noise(latents0, inputs["noise"], t0)
            if not isinstance(sch, DDIMScheduler):
                state = sch.init_state(x, num_steps)
        return self._decode(self._denoise(x, sch, ts_used, num_steps, context, unet_over,
                                          unet_lora, inputs["guidance"], state))

    @staticmethod
    def _postprocess(images: torch.Tensor, output_type: str):
        """uint8 (B, H, W, 3): "device" keeps the tensor where it is (no
        host sync), "np" gives floats in [0, 1], "pil" a list of images,
        anything else the uint8 array."""
        if output_type == "device":
            return images
        arr = images.cpu().numpy()
        if output_type == "np":
            return arr.astype(np.float32) / 255.0
        if output_type == "pil":
            from PIL import Image

            return [Image.fromarray(im) for im in arr]
        return arr


def _tree_to(tree, device, dtype):
    """A LoRA tree's up/down leaves in ``dtype`` and its scale leaves in
    fp32, all on ``device`` (leaves already there are kept, not copied)."""
    return {k: _tree_to(v, device, dtype) if isinstance(v, dict) else
            torch.as_tensor(v).to(device, torch.float32 if k == "scale" else dtype)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# patch_pipe / build_adapter / tune_lora_scale_pipe (JAX :1062-1196;
# reference lora.py:672-732, 597-600)
# ---------------------------------------------------------------------------


def patch_pipe(pipe: StableDiffusionPipeline, maybe_unet_path: str,
               token: Optional[str] = None, r: int = 4, patch_unet: bool = True,
               patch_text: bool = False, patch_ti: bool = False,
               idempotent_token: bool = True,
               unet_target_replace_module: set = lora_lib.DEFAULT_TARGET_REPLACE,
               text_target_replace_module: set = lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE
               ) -> StableDiffusionPipeline:
    """Install the LoRA/TI of ``.pt`` side-car files or a consolidated
    ``.safetensors`` on ``pipe`` (reference lora.py:672-732).  The whole
    load and install holds the pipe's swap lock, so a concurrent request
    sees the old set or the new one, and two patches serialise (each builds
    on the other's TI table)."""
    with pipe._swap_lock:
        updates = _compute_patch_updates(
            pipe, maybe_unet_path, token, r, patch_unet, patch_text, patch_ti,
            idempotent_token, unet_target_replace_module, text_target_replace_module)
        for attr, value in updates.items():
            setattr(pipe, attr, value)
    return pipe


def build_adapter(pipe: StableDiffusionPipeline, path: str, token: Optional[str] = None,
                  r: int = 4, patch_unet: bool = True, patch_text: bool = True,
                  patch_ti: bool = True, idempotent_token: bool = True,
                  unet_target_replace_module: set = lora_lib.DEFAULT_TARGET_REPLACE,
                  text_target_replace_module: set = lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE
                  ) -> Dict[str, Any]:
    """The loading half of :func:`patch_pipe`, installing nothing (JAX
    :1092): a dict of whichever of ``unet_lora``, ``text_encoder_lora`` and
    ``text_params`` the file gives, for ``GenerationServer.register_adapter``.
    TI tokens join the shared tokenizer (the vocabulary grows once); their
    rows live only in the returned ``text_params``."""
    with pipe._swap_lock:
        return _compute_patch_updates(
            pipe, path, token, r, patch_unet, patch_text, patch_ti, idempotent_token,
            unet_target_replace_module, text_target_replace_module)


def _text_table(pipe: StableDiffusionPipeline) -> Dict[str, torch.Tensor]:
    """The installed text overrides, with the module's token table when
    they hold none."""
    emb = pipe.text_encoder.text_model.embeddings.token_embedding.weight
    return {TOKEN_EMBEDDING: emb, **pipe.text_params}


def _compute_patch_updates(pipe, maybe_unet_path, token, r, patch_unet, patch_text, patch_ti,
                           idempotent_token, unet_target_replace_module,
                           text_target_replace_module) -> Dict[str, Any]:
    updates: Dict[str, Any] = {}
    tree_kw = dict(dtype=pipe.dtype, device=pipe.device)
    with torch.inference_mode(False), torch.no_grad():
        if maybe_unet_path.endswith(".pt"):
            if maybe_unet_path.endswith(".ti.pt"):
                unet_path = maybe_unet_path[:-6] + ".pt"
            elif maybe_unet_path.endswith(".text_encoder.pt"):
                unet_path = maybe_unet_path[:-16] + ".pt"
            else:
                unet_path = maybe_unet_path
            if patch_unet:
                print("LoRA : Patching Unet")
                updates["unet_lora"] = lora_lib.monkeypatch_or_replace_lora(
                    unet_path, pipe.lora_targets("unet", unet_target_replace_module), r=r,
                    **tree_kw)
            if patch_text:
                print("LoRA : Patching text encoder")
                updates["text_encoder_lora"] = lora_lib.monkeypatch_or_replace_lora(
                    lora_lib._text_lora_path(unet_path),
                    pipe.lora_targets("text_encoder", text_target_replace_module), r=r,
                    **tree_kw)
            if patch_ti:
                print("LoRA : Patching token input")
                updates["text_params"], token = load_learned_embed_in_clip(
                    lora_lib._ti_lora_path(unet_path), _text_table(pipe), pipe.tokenizer,
                    token=token, idempotent=idempotent_token)
        elif maybe_unet_path.endswith(".safetensors"):
            tensors, metadata = lora_lib.safetensors_io.read_safetensors(maybe_unet_path)
            for name, (flat, ranks, target) in lora_lib.parse_safeloras(tensors,
                                                                        metadata).items():
                try:
                    targets = pipe.lora_targets(name, set(target))
                except KeyError:
                    print(f"No model provided for {name}, contained in Lora")
                    continue
                updates[f"{name}_lora"] = lora_lib.flat_to_lora_tree(flat, targets, **tree_kw)
            tok_dict = lora_lib.parse_safeloras_embeds(tensors, metadata)
            if tok_dict:
                updates["text_params"], token = apply_learned_embed_in_clip(
                    tok_dict, _text_table(pipe), pipe.tokenizer, token=token,
                    idempotent=idempotent_token)
    return updates


def tune_lora_scale_pipe(pipe: StableDiffusionPipeline, alpha: float = 1.0,
                         which: str = "both") -> None:
    """Set the installed trees' scales to ``alpha`` (new trees: the merged
    set is rebuilt, a graph's buffers refilled, nothing captured)."""
    with pipe._swap_lock:
        if which in ("both", "unet") and pipe.unet_lora is not None:
            pipe.unet_lora = lora_lib.tune_lora_scale(pipe.unet_lora, alpha)
        if which in ("both", "text") and pipe.text_encoder_lora is not None:
            pipe.text_encoder_lora = lora_lib.tune_lora_scale(pipe.text_encoder_lora, alpha)
