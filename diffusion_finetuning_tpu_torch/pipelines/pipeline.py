"""Stable Diffusion txt2img and img2img pipeline (port of the JAX
``pipelines/pipeline.py``).

``__call__`` is the serving path: CLIP encode of the CFG pair
``[uncond; cond]``, a DDIM loop whose every step runs the UNet once on the
doubled batch and mixes ``eps = eps_u + g * (eps_c - eps_u)``, VAE decode of
``latents / 0.18215``, then ``clip(x / 2 + 0.5)``, ``round(x * 255)`` and
uint8.  :meth:`~StableDiffusionPipeline.img2img` (JAX :945, ``_build_img2img_fn`` :808)
starts the same loop part-way: VAE encode of the init image, a posterior
sample times 0.18215 for every prompt, forward noising to the first used
timestep, then the DDIM steps from there.  On the card the UNet's attention
calls go through the flash-attention kernels, with a dynamic LoRA its LoRA
projections through the fused LoRA kernel, and with ``DFT_CONV_PALLAS`` its
resnet 3x3 convs through the fused conv.

On the card a whole request -- text encode, the denoise loop, VAE decode
and uint8 (img2img: also the VAE encode and the forward noising) -- is one
CUDA graph (``graph.py``), as the JAX pipeline jits one executable per key
(``_cached`` :303, ``_build_denoise_fn`` :567, ``_build_img2img_fn`` :808).
The key: the request kind, steps (and img2img's first step), height, width,
scheduler, batch; the scheduler config; the installed LoRA trees by
identity and the LoRA policy; the two kernel switches.  The first request
of a key captures its graph, later ones copy their inputs into its static
buffers and replay it: the token ids, the initial latents (drawn eagerly
per seed, as before), img2img's init image and draws, and the guidance
scale, a 0-d device tensor (a new scale does not re-capture).  The JAX key
also holds the latents mode; here given and seeded latents feed the same
buffer.  ``cuda_graphs = False`` runs requests eagerly on the card, the
reference the graphs are held against; on the CPU they always run eagerly.

LoRA serving follows the JAX pipeline's policy (:154-165): with
``materialize_lora`` (the default) the installed tree is folded into the
weights once per tree (``lora.materialize_lora_tree``) and cached by tree
identity, and generation runs the merged weights; with it off, the tree is
attached to the LoRA layers for the call (the dynamic path).  Trees are
swapped, never edited in place (``tune_lora_scale`` returns a new tree);
call :meth:`invalidate_merged_cache` after an in-place edit (it drops the
graphs too).

Public layouts are the JAX package's: ``latents`` (B, h, w, 4), images
(B, H, W, 3), img2img's init image (H, W, 3).  The model modules run NCHW.
``from_pretrained``, multi-device sharding, ``patch_pipe`` and the other
schedulers (txt2img and img2img) come in later slices.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from .. import lora as lora_lib
from .. import resolve_device
from ..data.tokenizer import CLIPTokenizer
from ..graph import Graphs
from ..models.layers import kernel_switches
from ..models.clip_text import CLIPTextConfig, CLIPTextModel, text_encoder_lora_targets
from ..models.schedulers import DDIMScheduler, DDPMScheduler, SchedulerConfig
from ..models.unet import UNet2DConditionModel, UNetConfig, unet_all_lora_targets
from ..models.vae import SCALING_FACTOR, AutoencoderKL, VAEConfig
from ..models.weights import load_module


def img2img_start(num_steps: int, strength: float) -> int:
    """The first grid step img2img runs (JAX :999): strength 1 starts from
    the top, strength 0 still runs the last step."""
    return int(min(num_steps - 1, round((1 - strength) * num_steps)))


class StableDiffusionPipeline:
    """Bundles the UNet, VAE and CLIP modules, the tokenizer and the
    scheduler config, plus the installed LoRA trees ``unet_lora`` /
    ``text_encoder_lora`` (JAX-path-addressed, see ``lora.py``)."""

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
        # fold LoRA deltas into the weights for generation (JAX :154-165);
        # False runs the dynamic path through the LoRA kernel
        self.materialize_lora: bool = True
        # whole requests through CUDA graphs on the card; False runs them
        # eagerly there (the graphs' reference)
        self.cuda_graphs: bool = True
        self._merged_current: Dict[str, Tuple] = {}
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

    # -- LoRA materialization ----------------------------------------------
    def invalidate_merged_cache(self) -> None:
        """Drop the merged weights and the request graphs: the next request
        merges and captures anew."""
        with self._swap_lock:
            self._merged_current.clear()
            if self._graphs is not None:
                self._graphs.graphs.clear()

    def _merged(self, which: str, model, lora, dynamic: bool = False):
        """Merged weights for ``lora`` (``dynamic``: the tree itself on the
        model's device and dtype), cached while the same tree object stays
        installed (identity, as the JAX cache).  They are built outside
        inference mode, as ordinary tensors that need no grad, so that
        per-weight caches keyed on a tensor's version (the fused conv's
        tap-major copy, ``ops/conv3x3.py:tap_major``) can hold them: the
        generation entry points run under ``torch.inference_mode()``, whose
        tensors have no version counter.  A dynamic tree is moved once, not
        in every request: a CUDA graph cannot capture a copy from host
        memory."""
        slot = which + (" dynamic" if dynamic else "")
        hit = self._merged_current.get(slot)
        if hit is not None and hit[0] is lora:
            return hit[1]
        w = next(model.parameters())
        with torch.inference_mode(False), torch.no_grad():
            out = (_tree_to(lora, w.device, w.dtype) if dynamic
                   else lora_lib.materialize_lora_tree(model, lora))
        self._merged_current[slot] = (lora, out)
        return out

    def _generation_params(self):
        """(unet overrides, unet lora, text overrides, text lora) under the
        materialization policy, read as one consistent set."""
        with self._swap_lock:
            unet_lora, text_lora = self.unet_lora, self.text_encoder_lora
            mat = self.materialize_lora
            unet_over: Dict[str, torch.Tensor] = {}
            text_over: Dict[str, torch.Tensor] = {}
            if unet_lora is not None:
                unet_lora = self._merged("unet", self.unet, unet_lora, dynamic=not mat)
                if mat:
                    unet_over, unet_lora = unet_lora, None
            if text_lora is not None:
                text_lora = self._merged("text", self.text_encoder, text_lora, dynamic=not mat)
                if mat:
                    text_over, text_lora = text_lora, None
            return unet_over, unet_lora, text_over, text_lora

    def _generate(self, key: tuple, body, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``body(params, inputs)`` -> uint8 images, ``params`` from
        :meth:`_generation_params`.  On the card (unless ``cuda_graphs`` is
        off) through the CUDA graph of ``key`` and of what the graph reads
        besides ``inputs``: captured by the first request, replayed with the
        new inputs copied into its static buffers by later ones."""
        if self.device.type != "cuda" or not self.cuda_graphs:
            return body(self._generation_params(), inputs)
        with self._swap_lock:  # one request at a time through a graph's buffers
            params = self._generation_params()
            trees = (self.materialize_lora, self.unet_lora, self.text_encoder_lora)
            key = key + (self.scheduler_config, trees[0], id(trees[1]), id(trees[2]),
                         kernel_switches())
            if self._graphs is None:
                self._graphs = Graphs(self.device)
            return self._graphs.run(key, lambda static: body(params, static), inputs,
                                    holds=(trees, params)).clone()

    # -- text encoding ------------------------------------------------------
    def _tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = self.tokenizer(list(prompts), padding="max_length", truncation=True,
                             max_length=self.tokenizer.model_max_length,
                             return_tensors="np")["input_ids"]
        rows = self.text_encoder.text_model.embeddings.token_embedding.num_embeddings
        if int(ids.max()) >= rows:
            raise ValueError(f"prompt tokenizes to id {int(ids.max())} but the text "
                             f"encoder's embedding table has {rows} rows")
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def _encode(self, ids, text_over, text_lora) -> torch.Tensor:
        with lora_lib.attached(self.text_encoder, text_lora):
            return functional_call(self.text_encoder, text_over, (ids,))

    @torch.inference_mode()
    def encode_prompt(self, prompts: Sequence[str]) -> torch.Tensor:
        _, _, text_over, text_lora = self._generation_params()
        return self._encode(self._tokenize(prompts), text_over, text_lora)

    # -- generation ---------------------------------------------------------
    def _initial_latents(self, b, height, width, latents, seed) -> torch.Tensor:
        f = self.vae_scale_factor
        shape = (self.unet_config.in_channels, height // f, width // f)
        if latents is not None:
            lat = torch.as_tensor(np.asarray(latents) if not isinstance(latents, torch.Tensor)
                                  else latents)
            lat = lat.to(self.device, torch.float32).permute(0, 3, 1, 2)
            if tuple(lat.shape) != (b,) + shape:
                raise ValueError(f"latents {tuple(lat.shape)} != {(b,) + shape} (NCHW)")
            return lat.contiguous()
        seeds = [seed + i for i in range(b)] if isinstance(seed, int) else list(seed)
        if len(seeds) != b:
            raise ValueError("one seed per prompt")
        out = []
        for s in seeds:  # per-seed draws: a seed's latents do not depend on the batch
            g = torch.Generator(device=self.device).manual_seed(int(s))
            out.append(torch.randn(shape, generator=g, device=self.device))
        return torch.stack(out)

    @torch.inference_mode()
    def __call__(self, prompt: Union[str, Sequence[str]],
                 negative_prompt: Union[str, Sequence[str]] = "",
                 height: int = 512, width: int = 512, num_inference_steps: int = 50,
                 guidance_scale: float = 7.5, seed: Union[int, Sequence[int]] = 0,
                 scheduler: str = "ddim", latents=None, output_type: str = "pil"):
        """``seed`` may be one int (element i gets ``seed + i``) or one per
        prompt; ``latents`` (B, h, w, 4) overrides the seeds."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        negs = ([negative_prompt] * len(prompts) if isinstance(negative_prompt, str)
                else list(negative_prompt))
        b = len(prompts)
        if len(negs) != b:
            raise ValueError(f"{len(negs)} negative prompts for {b} prompts")
        if scheduler != "ddim":
            raise ValueError(f"scheduler {scheduler!r} is not ported yet (only 'ddim')")

        inputs = {"ids": self._tokenize(negs + prompts),
                  "latents": self._initial_latents(b, height, width, latents, seed),
                  "guidance": self._guidance(guidance_scale)}
        images = self._generate(
            ("txt2img", num_inference_steps, height, width, scheduler, b),
            lambda params, inp: self._txt2img(params, inp, num_inference_steps), inputs)
        return self._postprocess(images, output_type)

    def _guidance(self, scale: float) -> torch.Tensor:
        return torch.full((), scale, dtype=torch.float32, device=self.device)

    def _txt2img(self, params, inputs, num_steps: int) -> torch.Tensor:
        unet_over, unet_lora, text_over, text_lora = params
        context = self._encode(inputs["ids"], text_over, text_lora)
        sch = DDIMScheduler(self.scheduler_config)
        x = self._denoise(inputs["latents"], sch, sch.timesteps(num_steps).tolist(), num_steps,
                          context, unet_over, unet_lora, inputs["guidance"])
        return self._decode(x)

    def _denoise(self, x, sch, timesteps, num_steps, context, unet_over, unet_lora, g):
        """The CFG loop over ``timesteps``: the UNet on [x; x] against
        ``context`` ([uncond; cond]), eps_u + g (eps_c - eps_u) in fp32 (``g``
        a 0-d fp32 device tensor), a ``sch.step`` each."""
        b = x.shape[0]
        with lora_lib.attached(self.unet, unet_lora):
            for t in timesteps:
                x2 = torch.cat([x, x])
                t2 = torch.full((2 * b,), t, dtype=torch.long, device=self.device)
                eps = functional_call(self.unet, unet_over, (x2, t2, context))
                eps_u, eps_c = eps.chunk(2)
                eps = eps_u.float() + g * (eps_c - eps_u).float()
                x = sch.step(eps, t, x, num_steps)
        return x

    def _decode(self, x) -> torch.Tensor:
        """Latents -> uint8 (B, H, W, 3) on the device."""
        images = self.vae.decode(x / SCALING_FACTOR).float()
        images = torch.clamp(images / 2 + 0.5, 0.0, 1.0)
        return torch.round(images * 255.0).to(torch.uint8).permute(0, 2, 3, 1)

    def img2img_draws(self, seed: int, batch: int, latent_hw: Tuple[int, int]) -> Dict:
        """img2img's two draws from one seeded generator on the device, in
        the latents' (B, h, w, C) layout: ``sample``, the posterior sample's
        noise for the one init image (1, h, w, C), and ``noise``, the forward
        noising's, one per prompt (batch, h, w, C).  The JAX pipeline draws
        both from ``jax.random.split(PRNGKey(seed))``, which torch cannot
        reproduce; the parity tests hand JAX's draws to :meth:`img2img`."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        c = self.unet_config.in_channels
        return {"sample": torch.randn((1, *latent_hw, c), generator=gen, device=self.device),
                "noise": torch.randn((batch, *latent_hw, c), generator=gen, device=self.device)}

    @torch.inference_mode()
    def img2img(self, prompt: Union[str, Sequence[str]], init_image,
                strength: float = 0.75, negative_prompt: Union[str, Sequence[str]] = "",
                num_inference_steps: int = 50, guidance_scale: float = 7.5, seed: int = 0,
                scheduler: str = "ddim", output_type: str = "pil", draws=None):
        """SDEdit-style img2img (JAX :945-1031, the reference
        ``scripts/run_img2img.ipynb`` flow) with the DDIM scheduler.

        ``init_image`` (H, W, 3), uint8 or floats in [0, 1], is mapped to
        [-1, 1] and encoded; one posterior sample times 0.18215 serves every
        prompt, each with its own forward noise to ``ts[t_start]``, where
        ``t_start = min(len(ts) - 1, round((1 - strength) * len(ts)))``
        (Python's half-to-even ``round``: strength 0.75 at 50 steps starts
        at step 12 and runs 38); the CFG loop then runs ``ts[t_start:]``.
        ``draws`` (see :meth:`img2img_draws`) replaces the seeded draws."""
        if scheduler != "ddim":
            raise ValueError(
                f"img2img scheduler {scheduler!r} is not ported yet (only 'ddim'); the "
                "others are queued in ROADMAP.md Queue A")
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

        ts = DDIMScheduler(self.scheduler_config).timesteps(num_inference_steps).tolist()
        t_start = img2img_start(len(ts), strength)
        if draws is None:
            draws = self.img2img_draws(seed, b, (h // f, w // f))

        def draw(key):
            d = draws[key]
            d = d if isinstance(d, torch.Tensor) else torch.from_numpy(np.array(d, np.float32))
            return d.to(self.device, torch.float32).permute(0, 3, 1, 2)

        inputs = {"ids": self._tokenize(negs + prompts), "image": x, "sample": draw("sample"),
                  "noise": draw("noise"), "guidance": self._guidance(guidance_scale)}
        images = self._generate(
            ("img2img", num_inference_steps, t_start, h, w, scheduler, b),
            lambda params, inp: self._img2img(params, inp, num_inference_steps, ts[t_start:]),
            inputs)
        return self._postprocess(images, output_type)

    def _img2img(self, params, inputs, num_steps: int, ts_used) -> torch.Tensor:
        unet_over, unet_lora, text_over, text_lora = params
        context = self._encode(inputs["ids"], text_over, text_lora)
        post = self.vae.encode(inputs["image"])
        latents0 = (post.sample(noise=inputs["sample"]) * SCALING_FACTOR).repeat(
            inputs["noise"].shape[0], 1, 1, 1)
        t0 = torch.full((1,), ts_used[0], dtype=torch.long, device=self.device)
        cfg = self.scheduler_config
        ddpm = self._ddpm.get(cfg)
        if ddpm is None:
            ddpm = self._ddpm[cfg] = DDPMScheduler(cfg)
        x = ddpm.add_noise(latents0.float(), inputs["noise"], t0)
        return self._decode(self._denoise(x, DDIMScheduler(cfg), ts_used, num_steps, context,
                                          unet_over, unet_lora, inputs["guidance"]))

    @staticmethod
    def _postprocess(images: torch.Tensor, output_type: str):
        """uint8 (B, H, W, 3): "device" keeps the tensor where it is, "np"
        gives floats in [0, 1], "pil" a list of images, anything else the
        uint8 array."""
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
