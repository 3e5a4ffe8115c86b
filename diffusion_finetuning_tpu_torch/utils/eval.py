"""Evaluation and visualisation (port of the JAX package's ``utils/eval.py``,
reference ``lora_diffusion/utils.py``): the textual-inversion paper's CLIP
alignment metrics (utils.py:73-100), ``evaluate_pipe`` over the 32
``EXAMPLE_PROMPTS`` (utils.py:18-51, 112-163), ``image_grid``
(utils.py:54-70) and ``visualize_progress`` over LoRA checkpoints
(utils.py:166-214), against the port's pipeline.

The alignment arithmetic is numpy, as in JAX.  The CLIP embedding models
are ``transformers``' torch CLIP, imported inside
:func:`prepare_clip_model_sets` only: the metrics sit beside the
generation path, and a machine without ``transformers`` imports this
module all the same.
"""

from __future__ import annotations

import glob
import math
import os
from typing import List, Optional, Union

import numpy as np
import torch
from PIL import Image

EXAMPLE_PROMPTS = [
    "<obj> swimming in a pool",
    "<obj> at a beach with a view of seashore",
    "<obj> in times square",
    "<obj> wearing sunglasses",
    "<obj> in a construction outfit",
    "<obj> playing with a ball",
    "<obj> wearing headphones",
    "<obj> oil painting ghibli inspired",
    "<obj> working on the laptop",
    "<obj> with mountains and sunset in background",
    "Painting of <obj> at a beach by artist claude monet",
    "<obj> digital painting 3d render geometric style",
    "A screaming <obj>",
    "A depressed <obj>",
    "A sleeping <obj>",
    "A sad <obj>",
    "A joyous <obj>",
    "A frowning <obj>",
    "A sculpture of <obj>",
    "<obj> near a pool",
    "<obj> at a beach with a view of seashore",
    "<obj> in a garden",
    "<obj> in grand canyon",
    "<obj> floating in ocean",
    "<obj> and an armchair",
    "A maple tree on the side of <obj>",
    "<obj> and an orange sofa",
    "<obj> with chocolate cake on it",
    "<obj> with a vase of rose flowers on it",
    "A digital illustration of <obj>",
    "Georgia O'Keeffe style <obj> painting",
    "A watercolor painting of <obj> on a beach",
]


def image_grid(_imgs: List[Image.Image], rows: Optional[int] = None,
               cols: Optional[int] = None) -> Image.Image:
    """Paste images into a grid (reference utils.py:54-70)."""
    if not _imgs:
        raise ValueError("image_grid: no images to arrange")
    if rows is None and cols is None:
        rows = cols = math.ceil(len(_imgs) ** 0.5)
    if rows is None:
        rows = math.ceil(len(_imgs) / cols)
    if cols is None:
        cols = math.ceil(len(_imgs) / rows)

    w, h = _imgs[0].size
    grid = Image.new("RGB", size=(cols * w, rows * h))
    for i, img in enumerate(_imgs):
        grid.paste(img, box=(i % cols * w, i // cols * h))
    return grid


def text_img_alignment(img_embeds: np.ndarray, text_embeds: np.ndarray,
                       target_img_embeds: np.ndarray) -> dict:
    """CLIP text/image alignment metrics (textual-inversion paper; reference
    utils.py:73-100) of (N, D) embeddings, numpy or host tensors."""
    img_embeds = np.asarray(img_embeds, np.float32)
    text_embeds = np.asarray(text_embeds, np.float32)
    target_img_embeds = np.asarray(target_img_embeds, np.float32)
    if img_embeds.shape[0] != text_embeds.shape[0]:
        raise ValueError(f"{img_embeds.shape[0]} image and {text_embeds.shape[0]} text embeds")

    def norm(x, keepdims=False):
        return np.linalg.norm(x, axis=-1, keepdims=keepdims)

    text_img_sim = (img_embeds * text_embeds).sum(-1) / (norm(img_embeds) * norm(text_embeds))
    img_n = img_embeds / norm(img_embeds, keepdims=True)
    avg_target = (target_img_embeds / norm(target_img_embeds, keepdims=True)).mean(0)
    img_img_sim = (img_n * avg_target[None, :]).sum(-1)

    return {
        "text_alignment_avg": float(text_img_sim.mean()),
        "image_alignment_avg": float(img_img_sim.mean()),
        "text_alignment_all": text_img_sim.tolist(),
        "image_alignment_all": img_img_sim.tolist(),
    }


def prepare_clip_model_sets(eval_clip_id: str = "openai/clip-vit-large-patch14"):
    """``transformers``' CLIP text and vision models with projection, its
    tokenizer and processor (utils.py:103-109), on the host."""
    from transformers import (CLIPProcessor, CLIPTextModelWithProjection, CLIPTokenizer,
                              CLIPVisionModelWithProjection)

    text_model = CLIPTextModelWithProjection.from_pretrained(eval_clip_id)
    tokenizer = CLIPTokenizer.from_pretrained(eval_clip_id)
    vis_model = CLIPVisionModelWithProjection.from_pretrained(eval_clip_id)
    processor = CLIPProcessor.from_pretrained(eval_clip_id)
    return text_model, tokenizer, vis_model, processor


def evaluate_pipe(pipe, target_images: List[Image.Image], class_token: str = "",
                  learnt_token: str = "", guidance_scale: float = 5.0, seed: int = 0,
                  clip_model_sets=None, eval_clip_id: str = "openai/clip-vit-large-patch14",
                  n_test: int = 10, n_step: int = 50) -> dict:
    """Generate one image per ``EXAMPLE_PROMPTS[:n_test]`` (``<obj>`` ->
    ``learnt_token``) with the port's ``pipe`` and score its CLIP
    alignment with the prompt (``learnt_token`` -> ``class_token``) and with
    ``target_images`` (reference utils.py:112-163)."""
    if clip_model_sets is not None:
        text_model, tokenizer, vis_model, processor = clip_model_sets
    else:
        text_model, tokenizer, vis_model, processor = prepare_clip_model_sets(eval_clip_id)

    images, img_embeds, text_embeds = [], [], []
    for prompt in EXAMPLE_PROMPTS[:n_test]:
        prompt = prompt.replace("<obj>", learnt_token)
        img = pipe(prompt, num_inference_steps=n_step, guidance_scale=guidance_scale,
                   seed=seed)[0]
        images.append(img)

        with torch.no_grad():
            inputs = processor(images=img, return_tensors="pt")
            img_embeds.append(vis_model(**inputs).image_embeds.numpy())
            prompt = prompt.replace(learnt_token, class_token)
            inputs = tokenizer([prompt], padding=True, return_tensors="pt")
            text_embeds.append(text_model(**inputs).text_embeds.numpy())

    with torch.no_grad():
        inputs = processor(images=target_images, return_tensors="pt")
        target_img_embeds = vis_model(**inputs).image_embeds.numpy()

    return text_img_alignment(np.concatenate(img_embeds, 0), np.concatenate(text_embeds, 0),
                              target_img_embeds)


def visualize_progress(path_alls: Union[str, List[str]], prompt: str, model_id: str,
                       device: str = "cuda", patch_unet: bool = True, patch_text: bool = True,
                       patch_ti: bool = True, unet_scale: float = 1.0,
                       text_sclae: float = 1.0,  # sic: the reference's name (utils.py:174)
                       num_inference_steps: int = 50, guidance_scale: float = 5.0,
                       offset: int = 0, limit: int = 10, seed: int = 0) -> List[Image.Image]:
    """One fixed-seed image per checkpoint (a glob, sorted by mtime, or a
    list), each patched into a pipe read from ``model_id`` onto ``device``
    (reference utils.py:166-214)."""
    from ..pipelines.pipeline import StableDiffusionPipeline, patch_pipe, tune_lora_scale_pipe

    if isinstance(path_alls, str):
        alls = list(set(glob.glob(path_alls)))
        alls.sort(key=os.path.getmtime)
    else:
        alls = list(path_alls)
    if not alls:
        # fail before the pipeline load
        raise ValueError(f"visualize_progress: no checkpoints matched {path_alls!r}")

    pipe = StableDiffusionPipeline.from_pretrained(model_id, device=device)
    print(f"Found {len(alls)} checkpoints")

    imgs = []
    for path in alls[offset:limit]:
        print(path)
        patch_pipe(pipe, path, patch_unet=patch_unet, patch_text=patch_text, patch_ti=patch_ti)
        tune_lora_scale_pipe(pipe, unet_scale, which="unet")
        tune_lora_scale_pipe(pipe, text_sclae, which="text")
        imgs.append(pipe(prompt, num_inference_steps=num_inference_steps,
                         guidance_scale=guidance_scale, seed=seed)[0])
    return imgs
