"""``lora_pti``: the two-phase Pivotal Tuning Inversion trainer (port of the
JAX package's ``cli_lora_pti.py``; the reference's cli_lora_pti.py:47-770).

* :func:`get_models` -- load the pipeline from a diffusers directory, add
  the "|"-separated placeholder tokens and set their rows of the token
  table from ``<rand-sigma>``, ``<zero>`` or one initializer token
  (cli_lora_pti.py:70-107), numpy-drawn as in JAX.
* Phase 1 (inversion) -- train only the token-embedding matrix (the
  placeholder rows; the frozen rows are restored after every update) with
  AdamW, a per-batch LR schedule and gradient accumulation; on each update
  the updated rows are renormalised toward norm 0.4 with ``lambda = min(1,
  100 lr)`` (cli_lora_pti.py:251-405).
* Phase 2 (tuning) -- a rank-r UNet LoRA, optionally the text-encoder LoRA
  and the embeddings (``continue_inversion``, unconstrained),
  ``t_mutliplier=0.8``, global-norm clip 1.0 (cli_lora_pti.py:408-489).
* Checkpoints: ``step_inv_N.safetensors`` (embeddings only) and
  ``step_N.safetensors`` (UNet and text LoRA, embeddings) via ``save_all``;
  only what they hold is copied to the host.

Each phase is one :func:`~.training.train_step.build_train_step` driven by
a :class:`~.training.train_step.FusedDispatcher` (``steps_per_dispatch``
steps a CUDA graph on the card, clipped to the save window so that one
capture serves the phase).  The first phase's graphs and optimiser state
are freed before the second is captured.  One device, no mesh:
``tensor_parallel > 1`` raises.  The returned pipe holds the learned tokens
(in the text encoder's table) and the LoRA trees, and serves at once.

Run: ``python -m diffusion_finetuning_tpu_torch.cli_lora_pti
--instance_data_dir DIR --pretrained_model_name_or_path MODEL --output_dir
OUT [--flag value ...]`` (or the ``lora_pti_torch`` console script).
"""

from __future__ import annotations

import gc
import itertools
import os
import re
from typing import List, Optional

import numpy as np
import torch

from . import lora as lora_lib
from . import resolve_device
from .data.dataset import DataLoader, PivotalTuningDatasetCapation
from .models.clip_text import resize_token_embeddings, text_encoder_lora_targets, TOKEN_EMBEDDING
from .models.schedulers import DDPMScheduler
from .models.unet import unet_lora_targets
from .pipelines.pipeline import StableDiffusionPipeline
from .training.optim import ParamGroup, lr_schedule, multi_group_optimizer
from .training.train_step import (FusedDispatcher, TrainablePartition, build_train_step,
                                  init_train_state)
from .training.trainer_util import (DispatchLog, check_tensor_parallel, compute_dtype, detached,
                                    enable_gradient_checkpointing, host_tree,
                                    install_token_table, load_vae, token_table)
from .utils.cli import Fire


def get_models(pretrained_model_name_or_path: str, pretrained_vae_name_or_path: Optional[str],
               revision: Optional[str], placeholder_tokens: List[str],
               initializer_tokens: List[str], device="cuda", dtype=torch.float32):
    """Load the pipeline and install the placeholder tokens (reference
    cli_lora_pti.py:47-126).  Returns (pipe, placeholder token ids)."""
    del revision
    pipe = StableDiffusionPipeline.from_pretrained(pretrained_model_name_or_path, dtype=dtype,
                                                   device=device)
    if pretrained_vae_name_or_path:
        load_vae(pipe, pretrained_vae_name_or_path)

    tokenizer = pipe.tokenizer
    placeholder_token_ids = []
    rng = np.random.default_rng(0)
    emb = token_table(pipe).detach().float()
    for token, init_tok in zip(placeholder_tokens, initializer_tokens):
        num_added = tokenizer.add_tokens(token)
        if num_added == 0:
            raise ValueError(
                f"The tokenizer already contains the token {token}. Please pass"
                " a different `placeholder_token` that is not already in the"
                " tokenizer.")
        token_id = tokenizer.convert_tokens_to_ids(token)
        placeholder_token_ids.append(token_id)
        emb = resize_token_embeddings({TOKEN_EMBEDDING: emb}, len(tokenizer))[TOKEN_EMBEDDING]
        dim = emb.shape[1]
        if init_tok.startswith("<rand"):
            sigma_val = float(re.findall(r"<rand-(.*)>", init_tok)[0])
            row = rng.standard_normal(dim).astype(np.float32) * sigma_val
            print(f"Initialized {token} with random noise (sigma={sigma_val}), "
                  f"empirically {row.mean():.3f} +- {row.std():.3f}")
            print(f"Norm : {np.linalg.norm(row):.4f}")
        elif init_tok == "<zero>":
            row = np.zeros(dim, np.float32)
        else:
            init_ids = tokenizer._tokenize_text(init_tok)
            if len(init_ids) > 1:
                raise ValueError("The initializer token must be a single token.")
            row = emb[init_ids[0]].cpu().numpy()
        emb = emb.clone()
        emb[token_id] = torch.from_numpy(row).to(emb.device)
    install_token_table(pipe, emb)
    return pipe, placeholder_token_ids


def _save_checkpoint(pipe, params, partition, unet_targets, text_targets, placeholder_tokens,
                     placeholder_token_ids, path, save_lora=True):
    """``save_all`` of the LoRA trees and the placeholder rows; only those
    go to the host."""
    emb = params["ti_embeddings"] if partition.ti else token_table(pipe)
    ids = torch.tensor(placeholder_token_ids, device=emb.device)
    rows = emb.detach()[ids].float().cpu()
    learned = {tok: rows[i] for i, tok in enumerate(placeholder_tokens)}
    lora_lib.save_all(host_tree(params.get("unet_lora")), host_tree(params.get("text_lora")),
                      unet_targets, text_targets, learned, path, save_lora=save_lora)


def _mean_moved(tree) -> float:
    vals = list(itertools.chain(*lora_lib.inspect_lora(tree).values()))
    return float(np.mean(vals)) if vals else 0.0


def train(
    instance_data_dir: str,
    pretrained_model_name_or_path: str,
    output_dir: str,
    train_text_encoder: bool = False,
    pretrained_vae_name_or_path: Optional[str] = None,
    revision: Optional[str] = None,
    class_data_dir: Optional[str] = None,
    stochastic_attribute: Optional[str] = None,
    perform_inversion: bool = True,
    use_template: Optional[str] = None,
    placeholder_tokens: str = "<s>",
    placeholder_token_at_data: Optional[str] = None,
    initializer_tokens: Optional[str] = None,
    class_prompt: Optional[str] = None,
    with_prior_preservation: bool = False,
    prior_loss_weight: float = 1.0,
    num_class_images: int = 100,
    seed: int = 42,
    resolution: int = 512,
    color_jitter: bool = True,
    train_batch_size: int = 1,
    sample_batch_size: int = 1,
    max_train_steps_tuning: int = 1000,
    max_train_steps_ti: int = 1000,
    save_steps: int = 100,
    gradient_accumulation_steps: int = 4,
    gradient_checkpointing: bool = False,
    mixed_precision: str = "fp16",
    lora_rank: int = 4,
    lora_unet_target_modules=lora_lib.UNET_DEFAULT_TARGET_REPLACE,
    lora_clip_target_modules=lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
    clip_ti_decay: bool = True,
    learning_rate_unet: float = 1e-4,
    learning_rate_text: float = 1e-5,
    learning_rate_ti: float = 5e-4,
    continue_inversion: bool = True,
    continue_inversion_lr: Optional[float] = None,
    use_face_segmentation_condition: bool = False,
    scale_lr: bool = False,
    lr_scheduler: str = "linear",
    lr_warmup_steps: int = 0,
    lr_scheduler_lora: str = "linear",
    lr_warmup_steps_lora: int = 0,
    weight_decay_ti: float = 0.00,
    weight_decay_lora: float = 0.001,
    use_8bit_adam: bool = False,
    steps_per_dispatch: int = 1,
    tensor_parallel: int = 1,
    device: str = "cuda",
    extra_args: Optional[dict] = None,
    log_wandb: bool = False,
    wandb_log_prompt_cnt: int = 10,
    wandb_project_name: str = "new_pti_project",
    wandb_entity: str = "new_pti_entity",
):
    """Both phases; returns the pipe with the learned tokens and LoRA
    installed.  ``pipe.train_log`` holds each phase's dispatch summary
    (:class:`~.training.trainer_util.DispatchLog`), the inversion phase's
    with ``frozen_rows_changed``: the rows other than the placeholders'
    that differ from the initial table after it (0: the frozen rows came
    back bit-identical)."""
    check_tensor_parallel(tensor_parallel)
    dev = resolve_device(device)
    del num_class_images, sample_batch_size
    if log_wandb:
        import wandb

        wandb.init(project=wandb_project_name, entity=wandb_entity,
                   name=f"steps_{max_train_steps_ti}_lr_{learning_rate_ti}_"
                        f"{instance_data_dir.split('/')[-1]}",
                   reinit=True, config={"lr": learning_rate_ti, **(extra_args or {})})

    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)

    placeholder_tokens = placeholder_tokens.split("|")
    if initializer_tokens is None:
        print("PTI : Initializer Token not give, random inits")
        initializer_tokens = ["<rand-0.017>"] * len(placeholder_tokens)
    else:
        initializer_tokens = initializer_tokens.split("|")
    assert len(initializer_tokens) == len(placeholder_tokens), (
        "Unequal Initializer token for Placeholder tokens.")
    class_token = "".join(initializer_tokens)

    if placeholder_token_at_data is not None:
        tok, pat = placeholder_token_at_data.split("|")
        token_map = {tok: pat}
    else:
        token_map = {"DUMMY": "".join(placeholder_tokens)}

    print("Placeholder Tokens", placeholder_tokens)
    print("Initializer Tokens", initializer_tokens)

    pipe, placeholder_token_ids = get_models(
        pretrained_model_name_or_path, pretrained_vae_name_or_path, revision,
        placeholder_tokens, initializer_tokens, device=dev,
        dtype=compute_dtype(mixed_precision))
    if gradient_checkpointing:
        enable_gradient_checkpointing(pipe)

    noise_scheduler = DDPMScheduler(pipe.scheduler_config)

    if scale_lr:
        scale = gradient_accumulation_steps * train_batch_size
        unet_lr, text_encoder_lr, ti_lr = (learning_rate_unet * scale,
                                           learning_rate_text * scale, learning_rate_ti * scale)
    else:
        unet_lr, text_encoder_lr, ti_lr = learning_rate_unet, learning_rate_text, learning_rate_ti

    train_dataset = PivotalTuningDatasetCapation(
        instance_data_root=instance_data_dir, stochastic_attribute=stochastic_attribute,
        token_map=token_map, use_template=use_template,
        class_data_root=class_data_dir if with_prior_preservation else None,
        class_prompt=class_prompt, tokenizer=pipe.tokenizer, size=resolution,
        color_jitter=color_jitter,
        use_face_segmentation_condition=use_face_segmentation_condition, seed=seed)
    train_dataset.blur_amount = 200

    pad_id = pipe.tokenizer.encoder[pipe.tokenizer.pad_token]
    loader = DataLoader(train_dataset, train_batch_size, pad_id, seed=seed)

    # mask over embedding rows (the table only grows)
    ti_master = token_table(pipe).detach().float().clone().to(dev)
    index_updates = torch.zeros(ti_master.shape[0], dtype=torch.bool)
    index_updates[placeholder_token_ids] = True

    unet_targets = lora_lib.filter_targets(unet_lora_targets(pipe.unet_config),
                                           set(lora_unet_target_modules))
    text_targets = lora_lib.filter_targets(text_encoder_lora_targets(pipe.text_config),
                                           set(lora_clip_target_modules))
    generator = torch.Generator(device=dev).manual_seed(seed)
    init_generator = torch.Generator().manual_seed(seed)
    pipe.train_log = []

    preped_clip = None
    if log_wandb:
        try:
            from .utils.eval import prepare_clip_model_sets

            preped_clip = prepare_clip_model_sets()
        except Exception as e:  # offline environments: log loss only (JAX :303-310)
            print(f"wandb eval: CLIP models unavailable ({e}); logging loss only")

    def evaluate(table):
        """CLIP alignment of 50-step images with the inversion's current
        ``table`` as a text override of the pipe (JAX :409-430); the pipe's
        own overrides come back afterwards."""
        from PIL import Image

        from .utils.eval import evaluate_pipe

        own = pipe.text_params
        pipe.text_params = {**own, TOKEN_EMBEDDING: table.detach().to(pipe.dtype)}
        try:
            images = [Image.open(os.path.join(instance_data_dir, f))
                      for f in sorted(os.listdir(instance_data_dir))
                      if f.endswith((".png", ".jpg"))]
            return evaluate_pipe(pipe, target_images=images, class_token=class_token,
                                 learnt_token="".join(placeholder_tokens),
                                 n_test=wandb_log_prompt_cnt, n_step=50,
                                 clip_model_sets=preped_clip)
        finally:
            pipe.text_params = own

    def run_phase(partition, optimizer, num_steps, save_name, t_mutliplier, ti_sched, label,
                  accum=1, unet_lora=None, text_lora=None):
        loss_sum = 0.0
        state = init_train_state(
            optimizer, unet_lora=unet_lora if partition.unet_lora else None,
            text_lora=text_lora if partition.text_lora else None,
            ti_embeddings=ti_master if partition.ti else None, index_updates=index_updates,
            device=dev)
        params = state["params"]
        step_fn = build_train_step(
            unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae,
            scheduler=noise_scheduler, optimizer=optimizer, partition=partition,
            t_mutliplier=t_mutliplier, with_prior_preservation=with_prior_preservation,
            prior_loss_weight=prior_loss_weight, clip_ti_decay=clip_ti_decay,
            ti_lr_schedule=ti_sched, grad_accum_steps=accum)
        # clamp to the save window, so that every full group is one graph
        # (groups are clipped at save boundaries below)
        spd = max(1, steps_per_dispatch)
        if save_steps:
            spd = min(spd, save_steps)
        dispatcher = FusedDispatcher(step_fn, spd=spd)

        def batch_stream():
            while True:
                for batch in loader:
                    yield batch

        stream = batch_stream()

        def take_group(gs):
            # never straddle a save boundary with a fused group, so the
            # checkpoint cadence is the reference's; save_steps=0 never saves
            until_save = save_steps - (gs % save_steps) if save_steps else num_steps - gs
            take = min(dispatcher.spd, num_steps - gs, until_save)
            return [next(stream) for _ in range(take)]

        log = DispatchLog(label, dev)
        for state, losses, take, global_step in dispatcher.drive(state, generator, take_group,
                                                                  num_steps):
            log.tick(losses, take)
            if log_wandb:
                loss_sum = loss_sum + losses.sum()
            if global_step % 50 < take or global_step == num_steps:
                print(f"{label} step {global_step}/{num_steps} loss={float(losses[-1]):.4f}")
            if save_steps and global_step % save_steps == 0:
                _save_checkpoint(pipe, params, partition, unet_targets, text_targets,
                                 placeholder_tokens, placeholder_token_ids,
                                 os.path.join(output_dir, save_name.format(global_step)),
                                 save_lora=partition.unet_lora)
                if log_wandb and label == "inversion":
                    import wandb

                    wandb.log({"loss": float(loss_sum) / save_steps})
                    loss_sum = 0.0
                    if preped_clip is not None:
                        wandb.log(evaluate(params["ti_embeddings"]))
                if partition.unet_lora:
                    print("LORA Unet Moved", _mean_moved(params["unet_lora"]))
                if partition.text_lora:
                    print("LORA CLIP Moved", _mean_moved(params["text_lora"]))
            log.resume()
            if global_step >= num_steps:
                break
        pipe.train_log.append(log.summary())
        return {k: detached(v) for k, v in params.items()}

    def finish_phase():
        """Free the phase's graphs and optimiser state before the next."""
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

    # ---- PHASE 1: inversion ------------------------------------------------
    if perform_inversion:
        ti_sched = lr_schedule(lr_scheduler, ti_lr, lr_warmup_steps, max_train_steps_ti)
        partition = TrainablePartition(unet_lora=False, text_lora=False, ti=True)
        optimizer = multi_group_optimizer(
            {"ti_embeddings": ParamGroup(
                lr=ti_lr, schedule=lr_scheduler, warmup_steps=lr_warmup_steps,
                total_steps=max_train_steps_ti, weight_decay=weight_decay_ti,
                step_multiplier=gradient_accumulation_steps)},
            grad_accum_steps=gradient_accumulation_steps, use_8bit=use_8bit_adam)
        initial = ti_master
        out = run_phase(partition, optimizer, max_train_steps_ti, "step_inv_{}.safetensors",
                        t_mutliplier=1.0, ti_sched=ti_sched, label="inversion",
                        accum=gradient_accumulation_steps)
        # the inversion phase restores every row but the placeholders'
        frozen = ~index_updates.to(dev)
        pipe.train_log[-1]["frozen_rows_changed"] = int(
            (out["ti_embeddings"][frozen] != initial[frozen]).any(dim=1).sum())
        # the inverted embeddings into phase 2: the fp32 master for the TI
        # group, the table of the frozen text encoder otherwise
        ti_master = out["ti_embeddings"]
        install_token_table(pipe, ti_master)
        del out, optimizer
        finish_phase()

    # ---- PHASE 2: LoRA tuning ---------------------------------------------
    unet_lora = lora_lib.inject_trainable_lora(unet_targets, init_generator, r=lora_rank)
    print("Before training:")
    print(lora_lib.inspect_lora(unet_lora))

    groups = {"unet_lora": ParamGroup(
        lr=unet_lr, schedule=lr_scheduler_lora, warmup_steps=lr_warmup_steps_lora,
        total_steps=max_train_steps_tuning, weight_decay=weight_decay_lora)}
    partition2 = TrainablePartition(unet_lora=True, text_lora=train_text_encoder,
                                    ti=continue_inversion, ti_constrained=False)
    if continue_inversion:
        groups["ti_embeddings"] = ParamGroup(
            lr=continue_inversion_lr if continue_inversion_lr is not None else ti_lr,
            schedule="constant", weight_decay=weight_decay_lora)
    text_lora = None
    if train_text_encoder:
        text_lora = lora_lib.inject_trainable_lora(text_targets, init_generator, r=lora_rank)
        groups["text_lora"] = ParamGroup(
            lr=text_encoder_lr, schedule=lr_scheduler_lora, warmup_steps=lr_warmup_steps_lora,
            total_steps=max_train_steps_tuning, weight_decay=weight_decay_lora)
        print(lora_lib.inspect_lora(text_lora))

    optimizer2 = multi_group_optimizer(groups, max_grad_norm=1.0, use_8bit=use_8bit_adam)
    train_dataset.blur_amount = 70

    out = run_phase(partition2, optimizer2, max_train_steps_tuning, "step_{}.safetensors",
                    t_mutliplier=0.8, ti_sched=None, label="tuning", unet_lora=unet_lora,
                    text_lora=text_lora)
    del optimizer2
    finish_phase()

    # the final trees into the pipe, to serve at once
    pipe.unet_lora = out["unet_lora"]
    if train_text_encoder:
        pipe.text_encoder_lora = out["text_lora"]
    if continue_inversion:
        install_token_table(pipe, out["ti_embeddings"])
    return pipe


def main():
    Fire(train)


if __name__ == "__main__":
    main()
