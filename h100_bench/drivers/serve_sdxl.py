"""The SDXL serving driver (``"driver": "serve_sdxl"``): ``GenerationServer``
over the program's SDXL pipe, under the same loads as ``serve.py``.

It reuses ``serve.py`` (its schedule of requests, the pipe's wrapper that
records each dispatch, the open and closed loops, ``batch_rate`` and the
check inputs) and holds its own copies of what the harness knows only for
SD's three models: the weights of four models from the seed
(``text_encoder_2`` beside the UNet, ``text_encoder`` and VAE), the
program's pipe (``pipelines.pipeline_sdxl.StableDiffusionXLPipeline``), the
LoRA targets and trees of three models, and the reference's images
(``reference/sdxl.py``).  Traffic keys are ``serve.py``'s; a traffic's
``text_lora`` puts a LoRA on both towers.  Negative prompts are empty, so
the unconditional half is zeros in the program and the reference alike.

A checkout whose program has no SDXL pipe stops at once (exit code 2), before
any weights or kernels are built.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from h100_bench.harness import check as C
from h100_bench.harness import core
from h100_bench.harness import program as P
from h100_bench.harness import weights as W
from h100_bench.reference import models as RM
from h100_bench.reference import pipeline as RP
from h100_bench.reference import sdxl as RX

S = core.load_file(Path(__file__).resolve().parent / "serve.py", "driver")
ENTRY = "diffusion_finetuning_tpu_torch.pipelines.pipeline_sdxl"
KINDS = RX.KINDS  # unet, text_encoder, text_encoder_2, vae
# LoRA trees: (adapter pairs' key, the program's target set name, tree key)
TREES = (("unet", "unet", "unet_lora"), ("text", "text_encoder", "text_encoder_lora"),
         ("text_2", "text_encoder_2", "text_encoder_2_lora"))


def require_program() -> None:
    """Stop here, before anything heavy, when the program has no SDXL pipe."""
    try:
        found = importlib.util.find_spec(ENTRY) is not None
    except ModuleNotFoundError:
        found = False
    if not found:
        print(f"the program has no SDXL pipeline ({ENTRY})", file=sys.stderr)
        raise SystemExit(2)


# -- weights and LoRA pairs from the seed ---------------------------------------

def skeleton(kind: str, cfg: dict) -> nn.Module:
    with torch.device("meta"):
        return RX.build(kind, cfg)


def state_dict(kind: str, cfg: dict, seed: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """``weights.state_dict`` for SDXL's models: the same rules and draws,
    on the SDXL reference's skeletons."""
    rules = W._init_rules(skeleton(kind, cfg))
    g = torch.Generator(device=device).manual_seed(W.sub_seed(seed, "weights", kind))
    out: Dict[str, torch.Tensor] = {}
    uniform = [r for r in rules if r[2] == "uniform"]
    i = 0
    while i < len(uniform):
        j, n = i, 0
        while j < len(uniform) and (n == 0 or n + W._numel(uniform[j][1]) <= W.CHUNK):
            n += W._numel(uniform[j][1])
            j += 1
        buf = torch.rand(n, generator=g, device=device)
        o = 0
        for key, shape, _, b in uniform[i:j]:
            k = W._numel(shape)
            out[key] = (buf[o:o + k].view(shape) * (2 * b) - b).to(dtype)
            o += k
        del buf
        i = j
    normal = [r for r in rules if r[2] == "normal"]
    if normal:
        buf = torch.randn(sum(W._numel(r[1]) for r in normal), generator=g, device=device)
        o = 0
        for key, shape, _, _ in normal:
            out[key] = buf[o:o + W._numel(shape)].view(shape).to(dtype)
            o += W._numel(shape)
        del buf
    for key, shape, rule, _ in rules:
        if rule in ("one", "zero"):
            out[key] = (torch.ones if rule == "one" else torch.zeros)(shape, dtype=dtype,
                                                                      device=device)
    return {k: out[k] for k, _, _, _ in rules}


def lora_targets(kind: str, cfg: dict) -> List[Tuple[str, int, int]]:
    """(module name, in, out) of the reference's default LoRA targets of a
    model of the configuration, sorted."""
    return RX.lora_targets(skeleton(kind, cfg), kind)


def adapter_pairs(config: dict, traffic: dict, seed: int, device) -> Dict[str, dict]:
    """{adapter name: {"unet": pairs, "text": pairs or None, "text_2": pairs
    or None}} in fp32."""
    ad = traffic["adapters"]
    kinds = {"unet": "unet", "text": "text_encoder", "text_2": "text_encoder_2"}
    targets = {k: lora_targets(kind, config[kind]) for k, kind in kinds.items()}
    out = {}
    for i in range(ad["count"]):
        out[f"adapter{i}"] = {
            k: (W.lora_pairs(targets[k], seed, ("adapter", i, k), ad["rank"], ad["up_std"],
                             device) if k == "unet" or ad.get("text_lora") else None)
            for k in kinds}
    return out


# -- the program ------------------------------------------------------------------

def _tower_config(cls, cfg: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in cfg.items() if k in names and k != "projection_dim"}
    if "CLIPTextModelWithProjection" in cfg.get("architectures", []):
        kw["projection_dim"] = cfg["projection_dim"]
    return cls(**kw)


def scheduler_config(config: dict):
    """The program's scheduler config with the published grid spacing."""
    from diffusion_finetuning_tpu_torch.models.schedulers import SpacedSchedulerConfig

    names = {f.name for f in dataclasses.fields(SpacedSchedulerConfig)}
    return SpacedSchedulerConfig(**{k: v for k, v in config["scheduler"].items() if k in names})


def make_pipe(config: dict, seed: int, dtype: torch.dtype, device):
    """The program's SDXL pipe holding the seed's weights, made on the
    device in ``dtype``, with the benchmark's vocabulary in both
    tokenizers."""
    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig
    from diffusion_finetuning_tpu_torch.pipelines.pipeline_sdxl import StableDiffusionXLPipeline

    ucfg, vcfg, _, _ = P.configs(config)
    scfg = scheduler_config(config)
    t1 = _tower_config(CLIPTextConfig, config["text_encoder"])
    t2 = _tower_config(CLIPTextConfig, config["text_encoder_2"])
    sds = {k: state_dict(k, config[k], seed, dtype, device) for k in KINDS}
    vocab, merges = W.tokenizer_tables()
    return StableDiffusionXLPipeline(ucfg, sds["unet"], vcfg, sds["vae"], t1,
                                     sds["text_encoder"], CLIPTokenizer(vocab, merges), t2,
                                     sds["text_encoder_2"], CLIPTokenizer(vocab, merges), scfg,
                                     dtype=dtype, device=device)


def lora_tree(pipe, target_set: str, pairs) -> dict:
    """The program's LoRA tree of one model (``unet``, ``text_encoder``,
    ``text_encoder_2``) holding ``pairs``; its default targets must be the
    benchmark's, name for name."""
    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.tree_util import tree_set

    model = {"unet": pipe.unet, "text_encoder": pipe.text_encoder,
             "text_encoder_2": pipe.text_encoder_2}[target_set]
    replace = (lora_lib.UNET_DEFAULT_TARGET_REPLACE if target_set == "unet"
               else lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
    prefix = getattr(model, "lora_prefix", "")
    paths = {lora_lib.module_name(t.path, prefix): t.path
             for t in pipe.lora_targets(target_set, replace)}
    if set(paths) != set(pairs):
        raise RuntimeError(f"the program's {target_set} LoRA targets differ from the "
                           f"benchmark's: {sorted(set(paths) ^ set(pairs))[:4]}")
    tree: dict = {}
    for name, (up, down) in pairs.items():
        tree = tree_set(tree, paths[name], {
            "up": up, "down": down,
            "scale": torch.tensor(1.0, dtype=torch.float32, device=up.device)})
    return tree


class Run(S.Run):
    """``serve.Run`` over the SDXL pipe."""

    def __init__(self, ctx):
        require_program()
        super().__init__(ctx)

    def setup(self):
        from diffusion_finetuning_tpu_torch.serving import GenerationServer

        ctx, tr = self.ctx, self.tr
        P.build_kernels(self.device)
        dtype = P.DTYPES[self.cfg["serve_dtype"]]
        self.pipe = make_pipe(self.cfg, ctx.seed, dtype, self.device)
        if not ctx.cuda_graphs:
            self.pipe.cuda_graphs = False
        self.submitted: Dict[int, float] = {}
        self.proxy = S._PipeProxy(self.pipe, ctx.spans, self.submitted)
        self.server = GenerationServer(self.proxy, max_batch=tr["max_batch"])
        pairs = adapter_pairs(self.cfg, tr, ctx.seed, self.device)
        mat = tr["adapters"].get("materialize", False)
        for name, p in pairs.items():
            trees = {key: lora_tree(self.pipe, target_set, p[k])
                     for k, target_set, key in TREES if p[k] is not None}
            self.server.register_adapter(name, trees, materialize=mat)
            self.server._adapter_params(name)  # merged weights or device trees, built now
        del pairs
        self.requests = S.schedule(tr, ctx.seed, ctx.seconds)
        self._warm()
        self.graphs_before = self._graph_count()


# -- the reference ------------------------------------------------------------------

def reference_models(config: dict, seed: int, served_dtype: torch.dtype,
                     device) -> Dict[str, nn.Module]:
    """The reference's four modules, fp32, holding the seed's weights as the
    program was served them (rounded once to ``served_dtype``)."""
    out = {}
    for kind in KINDS:
        sd = state_dict(kind, config[kind], seed, served_dtype, device)
        m = skeleton(kind, config[kind])
        m.load_state_dict({k: v.float() for k, v in sd.items()}, assign=True)
        out[kind] = m.eval().requires_grad_(False)
        del sd
    return out


def serve_reference(config: dict, traffic: dict, seed: int, samples: List[dict],
                    pairs: Dict[str, dict], device, mode: str = "fp32",
                    models=None) -> List[np.ndarray]:
    """The reference's images of the sampled requests (the latent draw: a
    generator on the device seeded with the request's seed, one normal draw
    of (4, h, w)); each adapter's LoRA beside the layers, or merged into
    the weights and taken out again."""
    models = models or reference_models(config, seed, P.DTYPES[config["serve_dtype"]], device)
    by = {"unet": models["unet"], "text": models["text_encoder"],
          "text_2": models["text_encoder_2"]}
    sched = RX.Schedule(config["scheduler"])
    sample = RP.sampler(traffic["scheduler"])
    merged = traffic["adapters"].get("materialize", False)
    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    shape = (config["unet"]["in_channels"], traffic["height"] // f, traffic["width"] // f)
    scaling = config["vae"]["scaling_factor"]
    for name in sorted({s["adapter"] for s in samples}, key=str):
        p = pairs.get(name) or {}
        for k, model in by.items():
            if p.get(k) is not None:
                if merged:
                    RM.merge_lora(model, p[k])
                else:
                    RM.attach_lora(model, p[k])
        for s in (s for s in samples if s["adapter"] == name):
            g = torch.Generator(device=device).manual_seed(int(s["seed"]))
            lat = torch.randn(shape, generator=g, device=device)[None]
            ids = C.ids([s["prompt"]], device)
            img = RX.txt2img(models["unet"], models["text_encoder"], models["text_encoder_2"],
                             models["vae"], sched, sample, ids, ids, lat, traffic["guidance"],
                             traffic["steps"], scaling, f, mode=mode)
            s["_ref"] = img[0].cpu().numpy()
        for k, model in by.items():
            if p.get(k) is not None and merged:  # take the merge out again
                RM.merge_lora(model, {n: (-u, d) for n, (u, d) in p[k].items()})
            RM.attach_lora(model, None)
    return [s.pop("_ref") for s in samples]


def checks(ctx, inputs) -> List[tuple]:
    """The sampled requests' served images against the reference's."""
    samples = inputs["samples"]
    if not samples:
        return [("compared_requests", 0, ">= 1", False)]
    pairs = adapter_pairs(ctx.config, ctx.traffic, ctx.seed, ctx.device)
    ref = serve_reference(ctx.config, ctx.traffic, ctx.seed, samples, pairs, ctx.device)
    gaps = C.image_gaps([s["image"] for s in samples], ref)
    return [("compared_requests", len(samples), ">= 1", True)] + C.held(
        gaps, ctx.traffic["check"]["limits"], ("image_mean_abs_gap", "image_far_pixel_share"))


def readings(ctx, inputs, mode: str):
    """(program's numbers, the control's) against the fp32 reference; the
    control is the reference computed in ``mode``, its images rounded to
    bytes as the program serves them."""
    samples = inputs["samples"]
    models = reference_models(ctx.config, ctx.seed, P.DTYPES[ctx.config["serve_dtype"]],
                              ctx.device)
    pairs = adapter_pairs(ctx.config, ctx.traffic, ctx.seed, ctx.device)
    ref = serve_reference(ctx.config, ctx.traffic, ctx.seed, samples, pairs, ctx.device,
                          models=models)
    low = serve_reference(ctx.config, ctx.traffic, ctx.seed, samples, pairs, ctx.device,
                          mode=mode, models=models)
    return (C.image_gaps([s["image"] for s in samples], ref), C.image_gaps(S._u8(low), ref))


def adapter_faults(ctx, n: int) -> Dict[str, Dict[str, float]]:
    """The reference in the program's place with ``n`` of the run's
    requests served with the next adapter's LoRA (``adapter_swapped``; not
    read with one adapter, where it is the reference itself) or with none
    (``adapter_dropped``), its images rounded to bytes, against the fp32
    reference with the right adapter."""
    reqs = S.schedule(ctx.traffic, ctx.seed, ctx.seconds)
    rng = np.random.default_rng(W.sub_seed(ctx.seed, "faults"))
    samples = [dict(reqs[i]) for i in sorted(rng.choice(len(reqs), n, replace=False))]
    models = reference_models(ctx.config, ctx.seed, P.DTYPES[ctx.config["serve_dtype"]],
                              ctx.device)
    pairs = adapter_pairs(ctx.config, ctx.traffic, ctx.seed, ctx.device)
    names = sorted(pairs)
    ref = serve_reference(ctx.config, ctx.traffic, ctx.seed, samples, pairs, ctx.device,
                          models=models)
    faults = [("adapter_dropped", lambda a: None)]
    if len(names) > 1:
        faults.insert(0, ("adapter_swapped",
                          lambda a: names[(names.index(a) + 1) % len(names)]))
    out = {}
    for fault, other in faults:
        wrong = [dict(s, adapter=other(s["adapter"])) for s in samples]
        imgs = serve_reference(ctx.config, ctx.traffic, ctx.seed, wrong, pairs, ctx.device,
                               models=models)
        out[fault] = C.image_gaps(S._u8(imgs), ref)
    return out
