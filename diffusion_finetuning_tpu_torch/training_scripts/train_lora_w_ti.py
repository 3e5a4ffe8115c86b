"""Joint LoRA + Textual-Inversion trainer with a staged schedule (port of
the JAX repo's ``training_scripts/train_lora_w_ti.py``; the reference's
parse_args 285-626 and main 639-1209).

One training loop with three parameter groups (UNet LoRA, text-encoder
LoRA, TI embeddings):

* steps < ``--unfreeze_lora_step``: the LoRA groups' LRs are 0 (TI-only
  warm-up); after it the LoRA LRs are on and the TI LR is 0
  (train_lora_w_ti.py:988-994) -- ``StepGate`` LR gates read on the device
  step, so one captured step serves both stages;
* after every update, every row but the placeholder's is restored from a
  pre-training copy (train_lora_w_ti.py:1070-1075);
* captions come from the imagenet templates with the
  ``--stochastic_attribute`` random-subset augmentation (222-227);
* ``--just_ti`` trains only the embeddings (842-848);
* saves ``lora_weight_e{epoch}_s{step}.pt`` + ``.text_encoder.pt`` +
  ``.ti.pt`` and the final ``pt``/``safe``/``both`` output, the TI embed in
  the safetensors (1144-1202).  ``.ti.pt`` is a ``torch.save`` of ``{token:
  row}``, what ``pipelines.load_learned_embed_in_clip`` reads.

Run: ``python -m diffusion_finetuning_tpu_torch.training_scripts.train_lora_w_ti
--pretrained_model_name_or_path MODEL --instance_data_dir DIR --placeholder_token
"<krk>" --initializer_token dog [--flag value ...]``; ``torchrun
--nproc_per_node N -m ...`` spreads it over N ranks as the DreamBooth
trainer does (``trainer_mesh``, rank 0's I/O only).
"""

from __future__ import annotations

import argparse
import gc
import math
import os

import torch

from .. import lora as lora_lib
from ..data.dataset import DataLoader, DreamBoothTiDataset
from ..models.clip_text import TOKEN_EMBEDDING, resize_token_embeddings, text_encoder_lora_targets
from ..models.schedulers import DDPMScheduler
from ..models.unet import unet_lora_targets
from ..parallel import mesh as mesh_lib
from ..parallel import tp as tp_lib
from ..pipelines.pipeline import StableDiffusionPipeline
from ..training.optim import ParamGroup, StepGate, lr_schedule, multi_group_optimizer
from ..training.train_step import (FusedDispatcher, TrainablePartition, build_train_step,
                                   init_train_state)
from ..training.trainer_util import (DispatchLog, compute_dtype, main_print, mesh_graphs,
                                     enable_gradient_checkpointing, host_tree,
                                     install_token_table, load_vae, token_table)
from ..utils.profiling import MetricLogger, StepTimer
from .train_lora_dreambooth import synthesize_class_images


def parse_args(input_args=None):
    parser = argparse.ArgumentParser(description="Joint LoRA+TI training (CUDA).")
    a = parser.add_argument
    a("--pretrained_model_name_or_path", type=str, default=None, required=True)
    a("--pretrained_vae_name_or_path", type=str, default=None)
    a("--revision", type=str, default=None)
    a("--tokenizer_name", type=str, default=None)
    a("--instance_data_dir", type=str, default=None, required=True)
    a("--class_data_dir", type=str, default=None)
    a("--class_prompt", type=str, default=None)
    a("--placeholder_token", type=str, default=None, required=True)
    a("--stochastic_attribute", type=str, default=None)
    a("--initializer_token", type=str, default=None, required=True)
    a("--learnable_property", type=str, default="object")
    a("--with_prior_preservation", default=False, action="store_true")
    a("--prior_loss_weight", type=float, default=1.0)
    a("--num_class_images", type=int, default=100)
    a("--output_dir", type=str, default="text-inversion-model")
    a("--output_format", type=str, choices=["pt", "safe", "both"], default="both")
    a("--seed", type=int, default=None)
    a("--resolution", type=int, default=512)
    a("--center_crop", action="store_true")
    a("--color_jitter", action="store_true")
    # encode each distinct image once instead of every step (incompatible
    # with --color_jitter)
    a("--cache_latents", action="store_true")
    a("--train_text_encoder", action="store_true")
    a("--train_batch_size", type=int, default=4)
    a("--sample_batch_size", type=int, default=4)
    # denoise steps for class-image synthesis (reference hardcodes 50)
    a("--class_image_inference_steps", type=int, default=50)
    a("--num_train_epochs", type=int, default=1)
    a("--max_train_steps", type=int, default=None)
    a("--save_steps", type=int, default=500)
    a("--gradient_accumulation_steps", type=int, default=1)
    # this many train steps a dispatch: one CUDA graph of them on the card
    a("--steps_per_dispatch", type=int, default=1)
    a("--tensor_parallel", type=int, default=1,
      help="split the frozen UNet/CLIP projections over a tp mesh axis of "
           "this size (ranks: torchrun --nproc_per_node)")
    a("--gradient_checkpointing", action="store_true")
    a("--lora_rank", type=int, default=4)
    a("--learning_rate", type=float, default=5e-6)
    a("--learning_rate_text", type=float, default=5e-6)
    a("--learning_rate_ti", type=float, default=5e-4)
    a("--unfreeze_lora_step", type=int, default=1500)
    a("--just_ti", action="store_true")
    a("--scale_lr", action="store_true")
    a("--lr_scheduler", type=str, default="constant")
    a("--lr_warmup_steps", type=int, default=500)
    a("--use_8bit_adam", action="store_true")
    a("--adam_beta1", type=float, default=0.9)
    a("--adam_beta2", type=float, default=0.999)
    a("--adam_weight_decay", type=float, default=1e-2)
    a("--adam_epsilon", type=float, default=1e-08)
    a("--max_grad_norm", default=1.0, type=float)
    a("--logging_dir", type=str, default="logs")
    a("--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16"])
    a("--local_rank", type=int, default=-1)
    a("--resize", type=bool, default=True)
    a("--use_xformers", action="store_true")

    args = parser.parse_args(input_args)
    env_local_rank = int(os.environ.get("LOCAL_RANK", -1))
    if env_local_rank not in (-1, args.local_rank):
        args.local_rank = env_local_rank
    if args.with_prior_preservation:
        if args.class_data_dir is None:
            raise ValueError("You must specify a data directory for class images.")
        if args.class_prompt is None:
            raise ValueError("You must specify prompt for class images.")
    return args


def main(args, dataset_cls=None, device="cuda"):
    """Train; returns the final train state with ``state["log"]`` (the
    dispatch summary)."""
    if dataset_cls is None:
        dataset_cls = DreamBoothTiDataset
    dev = mesh_lib.rank_device(device)
    eff_batch = args.train_batch_size * (2 if args.with_prior_preservation else 1)
    mesh = mesh_lib.trainer_mesh(eff_batch, args.tensor_parallel, device=dev)
    print = main_print  # rank 0 alone prints
    generator = torch.Generator(device=dev).manual_seed(args.seed or 0)
    pipe = StableDiffusionPipeline.from_pretrained(
        args.pretrained_model_name_or_path, dtype=compute_dtype(args.mixed_precision),
        device=dev)
    if args.tokenizer_name:
        # separate tokenizer dir (reference train_lora_w_ti.py:720-724)
        from ..data.tokenizer import CLIPTokenizer

        pipe.tokenizer = CLIPTokenizer.from_pretrained(args.tokenizer_name)
    if args.pretrained_vae_name_or_path:
        load_vae(pipe, args.pretrained_vae_name_or_path)
    if args.with_prior_preservation:
        # synthesize the shortfall of class images (reference 671-688)
        if mesh_lib.is_main_process():
            synthesize_class_images(args, pipe)
        mesh_lib.barrier("class images")
    tokenizer = pipe.tokenizer

    # install the placeholder token, its row from the (single-token) initializer
    num_added = tokenizer.add_tokens(args.placeholder_token)
    if num_added == 0:
        raise ValueError(f"The tokenizer already contains the token {args.placeholder_token}.")
    init_ids = tokenizer._tokenize_text(args.initializer_token)
    if len(init_ids) > 1:
        raise ValueError("The initializer token must be a single token.")
    placeholder_token_id = tokenizer.convert_tokens_to_ids(args.placeholder_token)
    emb = resize_token_embeddings({TOKEN_EMBEDDING: token_table(pipe).detach().float()},
                                  len(tokenizer))[TOKEN_EMBEDDING].clone()
    emb[placeholder_token_id] = emb[init_ids[0]]
    install_token_table(pipe, emb)

    if args.gradient_checkpointing:
        enable_gradient_checkpointing(pipe)
    if args.use_xformers:
        # probe the flash kernels per head dim (reference 800-802)
        from ..xformers_utils import set_use_memory_efficient_attention_xformers

        set_use_memory_efficient_attention_xformers(pipe.unet_config, device=dev)

    unet_targets = lora_lib.filter_targets(unet_lora_targets(pipe.unet_config),
                                           lora_lib.DEFAULT_TARGET_REPLACE)
    text_targets = lora_lib.filter_targets(text_encoder_lora_targets(pipe.text_config),
                                           lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
    init_generator = torch.Generator().manual_seed(args.seed or 0)
    unet_lora = lora_lib.inject_trainable_lora(unet_targets, init_generator, r=args.lora_rank)
    text_lora = lora_lib.inject_trainable_lora(text_targets, init_generator, r=args.lora_rank)

    scheduler = DDPMScheduler(pipe.scheduler_config)

    train_dataset = dataset_cls(
        instance_data_root=args.instance_data_dir, placeholder_token=args.placeholder_token,
        stochastic_attribute=args.stochastic_attribute,
        learnable_property=args.learnable_property,
        class_data_root=args.class_data_dir if args.with_prior_preservation else None,
        class_prompt=args.class_prompt, tokenizer=tokenizer, size=args.resolution,
        center_crop=args.center_crop, color_jitter=args.color_jitter, resize=args.resize,
        seed=args.seed)
    pad_id = tokenizer.encoder[tokenizer.pad_token]
    loader = DataLoader(train_dataset, args.train_batch_size, pad_id, seed=args.seed or 0)

    steps_per_epoch = math.ceil(len(loader) / args.gradient_accumulation_steps)
    if args.max_train_steps is None:
        args.max_train_steps = args.num_train_epochs * steps_per_epoch
    num_train_epochs = math.ceil(args.max_train_steps / steps_per_epoch)

    lr, lr_text, lr_ti = args.learning_rate, args.learning_rate_text, args.learning_rate_ti
    if args.scale_lr:
        scale = (args.gradient_accumulation_steps * args.train_batch_size
                 * mesh_lib.process_count())
        lr, lr_text, lr_ti = lr * scale, lr_text * scale, lr_ti * scale

    unfreeze = args.unfreeze_lora_step
    common = dict(schedule=args.lr_scheduler, warmup_steps=args.lr_warmup_steps,
                  total_steps=args.max_train_steps, weight_decay=args.adam_weight_decay,
                  betas=(args.adam_beta1, args.adam_beta2), eps=args.adam_epsilon,
                  step_multiplier=args.gradient_accumulation_steps)
    if args.just_ti:
        groups = {"ti_embeddings": ParamGroup(lr=lr_ti, **common)}
        unet_lora = text_lora = None
        partition = TrainablePartition(unet_lora=False, text_lora=False, ti=True)
    else:
        groups = {
            "unet_lora": ParamGroup(lr=lr, lr_gate=StepGate(unfreeze), **common),
            "text_lora": ParamGroup(lr=lr_text, lr_gate=StepGate(unfreeze), **common),
            "ti_embeddings": ParamGroup(lr=lr_ti, lr_gate=StepGate(unfreeze, on_after=False),
                                        **common),
        }
        partition = TrainablePartition(unet_lora=True, text_lora=True, ti=True)

    optimizer = multi_group_optimizer(groups, grad_accum_steps=args.gradient_accumulation_steps,
                                      max_grad_norm=args.max_grad_norm,
                                      use_8bit=args.use_8bit_adam)
    # clip_ti_decay=False: w_ti restores the frozen rows but has no norm decay
    step_fn = build_train_step(
        unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae, scheduler=scheduler,
        optimizer=optimizer, partition=partition,
        with_prior_preservation=args.with_prior_preservation,
        prior_loss_weight=args.prior_loss_weight, clip_ti_decay=False,
        grad_accum_steps=args.gradient_accumulation_steps)

    index_updates = torch.zeros(emb.shape[0], dtype=torch.bool)
    index_updates[placeholder_token_id] = True
    state = init_train_state(optimizer, unet_lora=unet_lora, text_lora=text_lora,
                             ti_embeddings=emb, index_updates=index_updates, device=dev)
    del unet_lora, text_lora
    tp_lib.shard_models(mesh, pipe.unet, pipe.text_encoder)
    if mesh is not None:
        state = mesh_lib.shard_tree(state, mesh_lib.tp_state_shardings(mesh, state), mesh)
    params = state["params"]
    dispatcher = FusedDispatcher(step_fn, spd=max(1, args.steps_per_dispatch), mesh=mesh,
                                 cuda_graphs=mesh_graphs(mesh))

    print("***** Running training *****")
    print(f"  Num examples = {len(train_dataset)}")
    print(f"  Num Epochs = {num_train_epochs}")
    print(f"  Total optimization steps = {args.max_train_steps}")

    os.makedirs(args.output_dir, exist_ok=True)
    global_step, last_save = 0, 0

    # loss, per-group lr and steps/s to tensorboard (reference
    # train_lora_w_ti.py:645, 1161)
    logger = MetricLogger(log_dir=os.path.join(args.output_dir, args.logging_dir)
                          if mesh_lib.is_main_process() else None)
    timer = StepTimer()
    base_lrs = {name: lr_schedule(args.lr_scheduler, value, args.lr_warmup_steps,
                                  args.max_train_steps)
                for name, value in (("lr", lr), ("lr_text", lr_text), ("lr_ti", lr_ti))}

    def lrs_at(step):
        # host-side mirror of the staged gating on the device (ParamGroup.lr_gate)
        if args.just_ti:
            return {"lr_ti": float(base_lrs["lr_ti"](step))}
        on = float(step >= unfreeze)
        return {"lr": float(base_lrs["lr"](step)) * on,
                "lr_text": float(base_lrs["lr_text"](step)) * on,
                "lr_ti": float(base_lrs["lr_ti"](step)) * (1.0 - on)}

    def placeholder_row():
        return params["ti_embeddings"].detach()[placeholder_token_id].float().cpu()

    def save_periodic(epoch, step):
        base = f"{args.output_dir}/lora_weight_e{epoch}_s{step}"
        if not args.just_ti:
            lora_lib.save_lora_weight(params["unet_lora"], unet_targets, base + ".pt")
            lora_lib.save_lora_weight(params["text_lora"], text_targets,
                                      base + ".text_encoder.pt")
        torch.save({args.placeholder_token: placeholder_row()}, base + ".ti.pt")
        print(f"save weights {base}.pt")

    latent_cache = None
    if getattr(args, "cache_latents", False):
        if args.color_jitter:
            raise ValueError(
                "--cache_latents requires deterministic pixels; drop "
                "--color_jitter (h-flips are fine: each orientation gets "
                "its own cache entry)")
        from ..training.latent_cache import LatentMomentCache

        latent_cache = LatentMomentCache(pipe.vae, device=dev)

    def batch_stream():
        for epoch in range(num_train_epochs):
            for batch in loader:
                if latent_cache is not None:
                    batch = latent_cache.transform(batch)
                yield epoch, batch

    stream = batch_stream()
    stream_epoch = [0]

    def take_group(gs):
        # the staged gating flips on the device step, so fused groups may
        # straddle unfreeze_lora_step; clip only to the end
        take = min(dispatcher.spd, args.max_train_steps - gs)
        group = []
        for epoch, batch in stream:
            stream_epoch[0] = epoch
            group.append(batch)
            if len(group) == take:
                break
        return group

    log = DispatchLog("w_ti", dev)
    for state, losses, stepped, global_step in dispatcher.drive(
            state, generator, take_group, args.max_train_steps, start_step=global_step):
        log.tick(losses, stepped)
        epoch = stream_epoch[0]
        for _ in range(stepped):
            timer.tick()
        if global_step % 50 < stepped or global_step >= args.max_train_steps:
            loss = float(losses[-1])
            print(f"step {global_step}/{args.max_train_steps} "
                  f"loss={loss:.4f} ({timer.steps_per_sec:.2f} steps/s)")
            logger.log({"loss": loss, "steps_per_sec": timer.steps_per_sec,
                        **lrs_at(global_step)}, global_step)
        if (args.save_steps and global_step - last_save >= args.save_steps
                and mesh_lib.is_main_process()):
            save_periodic(epoch, global_step)
            last_save = global_step
        log.resume()

    mesh_lib.barrier("end of training")
    logger.close()
    run_log = {"dispatch": log.summary()}
    del dispatcher, step_fn
    gc.collect()
    print("\n\nLora TRAINING DONE!\n\n")
    state["log"] = run_log
    if not mesh_lib.is_main_process():
        return state

    row = placeholder_row()
    if args.output_format in ("pt", "both"):
        if not args.just_ti:
            lora_lib.save_lora_weight(params["unet_lora"], unet_targets,
                                      args.output_dir + "/lora_weight.pt")
            lora_lib.save_lora_weight(params["text_lora"], text_targets,
                                      args.output_dir + "/lora_weight.text_encoder.pt")
        torch.save({args.placeholder_token: row}, args.output_dir + "/lora_weight.ti.pt")
    if args.output_format in ("safe", "both") and not args.just_ti:
        lora_lib.save_all(host_tree(params["unet_lora"]), host_tree(params["text_lora"]),
                          unet_targets, text_targets, {args.placeholder_token: row},
                          args.output_dir + "/lora_weight.safetensors")
    return state


if __name__ == "__main__":
    main(parse_args())
