"""DreamBooth-with-LoRA trainer (port of the JAX repo's
``training_scripts/train_lora_dreambooth.py``; the reference's argparse
surface 168-483 and main 486-1003).

* prior-preservation class images synthesised through the pipeline's
  ``__call__`` (CUDA-graphed requests on the card), sha1 filenames, only
  the shortfall generated (reference 512-558);
* a rank-r LoRA on the UNet (and optionally the text encoder), with
  ``--resume_unet`` / ``--resume_text_encoder`` warm starts (595-621);
* AdamW with its own text-encoder LR, optional 8-bit moments, LR
  schedules, ``--scale_lr``, gradient accumulation, global-norm clipping
  (632-676, 737-742);
* the DDPM noise loss with optional prior preservation (811-888), one
  ``build_train_step`` driven by a ``FusedDispatcher``
  (``--steps_per_dispatch`` steps a CUDA graph on the card);
* periodic ``lora_weight_e{epoch}_s{step}.pt`` saves, the final
  ``pt``/``safe``/``both`` output (889-994), and with
  ``--full_state_checkpoint_dir`` the whole train state saved at each save
  and restored at start (``training/checkpoint.py``).

Run: ``python -m diffusion_finetuning_tpu_torch.training_scripts.train_lora_dreambooth
--pretrained_model_name_or_path MODEL --instance_data_dir DIR --instance_prompt
"a photo of sks dog" [--flag value ...]`` on one card (``main(args,
device="cpu")`` runs the plain versions on the CPU), ``torchrun
--nproc_per_node N -m diffusion_finetuning_tpu_torch.training_scripts.
train_lora_dreambooth ...`` on N: the ranks form ``trainer_mesh`` (``data``
over as many ranks as the per-step batch divides, ``--tensor_parallel``
ranks splitting the frozen UNet/CLIP projections), each steps on its rows of
the batch, and rank 0 alone prints, logs and saves.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from .. import lora as lora_lib
from ..data.dataset import DataLoader, DreamBoothDataset, PromptDataset
from ..models.clip_text import text_encoder_lora_targets
from ..models.schedulers import DDPMScheduler
from ..models.unet import unet_lora_targets
from ..parallel import mesh as mesh_lib
from ..parallel import tp as tp_lib
from ..pipelines.pipeline import StableDiffusionPipeline
from ..training import checkpoint as ckpt_lib
from ..training.optim import ParamGroup, lr_schedule, multi_group_optimizer
from ..training.train_step import (FusedDispatcher, TrainablePartition, build_train_step,
                                   init_train_state)
from ..training.trainer_util import (DispatchLog, compute_dtype, enable_gradient_checkpointing,
                                     host_tree, load_vae, main_print, mesh_graphs)
from ..utils.profiling import MetricLogger, StepTimer


def parse_args(input_args=None):
    parser = argparse.ArgumentParser(description="DreamBooth LoRA training (CUDA).")
    a = parser.add_argument
    a("--pretrained_model_name_or_path", type=str, default=None, required=True)
    a("--pretrained_vae_name_or_path", type=str, default=None)
    a("--revision", type=str, default=None)
    a("--tokenizer_name", type=str, default=None)
    a("--instance_data_dir", type=str, default=None, required=True)
    a("--class_data_dir", type=str, default=None)
    a("--instance_prompt", type=str, default=None, required=True)
    a("--class_prompt", type=str, default=None)
    a("--with_prior_preservation", default=False, action="store_true")
    a("--prior_loss_weight", type=float, default=1.0)
    a("--num_class_images", type=int, default=100)
    a("--output_dir", type=str, default="text-inversion-model")
    a("--output_format", type=str, choices=["pt", "safe", "both"], default="both")
    a("--seed", type=int, default=None)
    a("--resolution", type=int, default=512)
    a("--center_crop", action="store_true")
    a("--color_jitter", action="store_true")
    # encode each distinct image once instead of every step (the posterior
    # sample stays in the step); incompatible with --color_jitter
    a("--cache_latents", action="store_true")
    a("--train_text_encoder", action="store_true")
    a("--train_batch_size", type=int, default=4)
    a("--sample_batch_size", type=int, default=4)
    # denoise steps for prior-preservation class-image synthesis (the
    # reference hardcodes the pipeline default of 50)
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
    a("--scale_lr", action="store_true")
    a("--lr_scheduler", type=str, default="constant")
    a("--lr_warmup_steps", type=int, default=500)
    a("--use_8bit_adam", action="store_true")
    a("--adam_beta1", type=float, default=0.9)
    a("--adam_beta2", type=float, default=0.999)
    a("--adam_weight_decay", type=float, default=1e-2)
    a("--adam_epsilon", type=float, default=1e-08)
    a("--max_grad_norm", default=1.0, type=float)
    a("--push_to_hub", action="store_true")
    a("--hub_token", type=str, default=None)
    a("--logging_dir", type=str, default="logs")
    a("--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16"])
    a("--local_rank", type=int, default=-1)
    a("--resume_unet", type=str, default=None)
    a("--resume_text_encoder", type=str, default=None)
    a("--resize", type=bool, default=True, required=False)
    a("--use_xformers", action="store_true",
      help="probe the flash-attention kernels per head dim (on by default)")
    a("--full_state_checkpoint_dir", type=str, default=None,
      help="Save/auto-resume the FULL train state (params+optimizer+step) "
           "here every save_steps -- fault-tolerant resume beyond the "
           "reference's weights-only checkpoints.")

    args = parser.parse_args(input_args)
    env_local_rank = int(os.environ.get("LOCAL_RANK", -1))
    if env_local_rank not in (-1, args.local_rank):
        args.local_rank = env_local_rank

    if args.with_prior_preservation:
        if args.class_data_dir is None:
            raise ValueError("You must specify a data directory for class images.")
        if args.class_prompt is None:
            raise ValueError("You must specify prompt for class images.")
    else:
        if args.class_data_dir is not None:
            print("You need not use --class_data_dir without --with_prior_preservation.")
        if args.class_prompt is not None:
            print("You need not use --class_prompt without --with_prior_preservation.")
    return args


def synthesize_class_images(args, pipe: StableDiffusionPipeline):
    """Generate the shortfall of prior-preservation class images through
    the pipeline (reference train_lora_dreambooth.py:512-558), then free the
    request graphs before training."""
    class_images_dir = Path(args.class_data_dir)
    class_images_dir.mkdir(parents=True, exist_ok=True)
    cur_class_images = len(list(class_images_dir.iterdir()))
    if cur_class_images >= args.num_class_images:
        return
    num_new_images = args.num_class_images - cur_class_images
    print(f"Number of class images to sample: {num_new_images}.")
    sample_dataset = PromptDataset(args.class_prompt, num_new_images)
    bs = args.sample_batch_size
    for i in range(0, len(sample_dataset), bs):
        prompts = [sample_dataset[j]["prompt"]
                   for j in range(i, min(i + bs, len(sample_dataset)))]
        images = pipe(prompts, num_inference_steps=getattr(args, "class_image_inference_steps",
                                                           50),
                      height=args.resolution, width=args.resolution, seed=i)
        for j, image in enumerate(images):
            h = hashlib.sha1(image.tobytes()).hexdigest()
            image.save(class_images_dir / f"{cur_class_images + i + j}-{h}.jpg")
    pipe.release_graphs()


def main(args, device="cuda"):
    """Train; returns the final train state, with ``state["log"]``: the
    dispatch summary (``trainer_util.DispatchLog``), the full-state
    checkpoint save and restore ms, and the step a resumed run started at.
    Under a process group (torchrun) every rank calls it."""
    dev = mesh_lib.rank_device(device)
    # the data axis over as many ranks as the per-step batch divides (prior
    # preservation doubles it); tensor_parallel ranks split the projections
    eff_batch = args.train_batch_size * (2 if args.with_prior_preservation else 1)
    mesh = mesh_lib.trainer_mesh(eff_batch, args.tensor_parallel, device=dev)
    print = main_print  # rank 0 alone prints
    if args.seed is not None:
        np.random.seed(args.seed)
    generator = torch.Generator(device=dev).manual_seed(args.seed or 0)

    pipe = StableDiffusionPipeline.from_pretrained(
        args.pretrained_model_name_or_path, dtype=compute_dtype(args.mixed_precision),
        device=dev)
    if args.tokenizer_name:
        # separate tokenizer dir (reference train_lora_dreambooth.py:566-571)
        from ..data.tokenizer import CLIPTokenizer

        pipe.tokenizer = CLIPTokenizer.from_pretrained(args.tokenizer_name)
    if args.pretrained_vae_name_or_path:
        load_vae(pipe, args.pretrained_vae_name_or_path)
    if args.push_to_hub:
        print("WARNING: --push_to_hub is accepted for CLI parity but this "
              "build has no hub access; outputs stay in --output_dir.")

    if args.with_prior_preservation:
        if mesh_lib.is_main_process():
            synthesize_class_images(args, pipe)
        mesh_lib.barrier("class images")

    if args.gradient_checkpointing:
        enable_gradient_checkpointing(pipe)

    if args.use_xformers:
        # probe the flash kernels per head dim (reference 623-625)
        from ..xformers_utils import set_use_memory_efficient_attention_xformers

        set_use_memory_efficient_attention_xformers(pipe.unet_config, device=dev)

    unet_targets = lora_lib.filter_targets(unet_lora_targets(pipe.unet_config),
                                           lora_lib.DEFAULT_TARGET_REPLACE)
    text_targets = lora_lib.filter_targets(text_encoder_lora_targets(pipe.text_config),
                                           lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
    init_generator = torch.Generator().manual_seed(args.seed or 0)
    unet_lora = lora_lib.inject_trainable_lora(unet_targets, init_generator, r=args.lora_rank,
                                               loras=args.resume_unet)
    print("Before training: Unet First Layer lora up",
          lora_lib.extract_lora_ups_down(unet_lora, unet_targets)[0][0])
    text_lora = None
    if args.train_text_encoder:
        text_lora = lora_lib.inject_trainable_lora(text_targets, init_generator,
                                                   r=args.lora_rank,
                                                   loras=args.resume_text_encoder)
        print("Before training: text encoder First Layer lora up",
              lora_lib.extract_lora_ups_down(text_lora, text_targets)[0][0])

    scheduler = DDPMScheduler(pipe.scheduler_config)

    train_dataset = DreamBoothDataset(
        instance_data_root=args.instance_data_dir, instance_prompt=args.instance_prompt,
        class_data_root=args.class_data_dir if args.with_prior_preservation else None,
        class_prompt=args.class_prompt, tokenizer=pipe.tokenizer, size=args.resolution,
        center_crop=args.center_crop, color_jitter=args.color_jitter, resize=args.resize,
        seed=args.seed)
    pad_id = pipe.tokenizer.encoder[pipe.tokenizer.pad_token]
    loader = DataLoader(train_dataset, args.train_batch_size, pad_id, seed=args.seed or 0)

    steps_per_epoch = math.ceil(len(loader) / args.gradient_accumulation_steps)
    if args.max_train_steps is None:
        args.max_train_steps = args.num_train_epochs * steps_per_epoch
    num_train_epochs = math.ceil(args.max_train_steps / steps_per_epoch)

    if args.scale_lr:
        nodes = mesh_lib.process_count()
        lr = (args.learning_rate * args.gradient_accumulation_steps * args.train_batch_size
              * nodes)
        lr_text = (args.learning_rate_text * args.gradient_accumulation_steps
                   * args.train_batch_size * nodes)
    else:
        lr, lr_text = args.learning_rate, args.learning_rate_text

    common = dict(schedule=args.lr_scheduler, warmup_steps=args.lr_warmup_steps,
                  total_steps=args.max_train_steps, weight_decay=args.adam_weight_decay,
                  betas=(args.adam_beta1, args.adam_beta2), eps=args.adam_epsilon,
                  step_multiplier=args.gradient_accumulation_steps)
    groups = {"unet_lora": ParamGroup(lr=lr, **common)}
    if args.train_text_encoder:
        groups["text_lora"] = ParamGroup(lr=lr_text, **common)
    optimizer = multi_group_optimizer(groups, grad_accum_steps=args.gradient_accumulation_steps,
                                      max_grad_norm=args.max_grad_norm,
                                      use_8bit=args.use_8bit_adam)

    partition = TrainablePartition(unet_lora=True, text_lora=args.train_text_encoder, ti=False)
    step_fn = build_train_step(
        unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae, scheduler=scheduler,
        optimizer=optimizer, partition=partition,
        with_prior_preservation=args.with_prior_preservation,
        prior_loss_weight=args.prior_loss_weight)
    spd = max(1, args.steps_per_dispatch)

    state = init_train_state(optimizer, unet_lora=unet_lora, text_lora=text_lora, device=dev)
    del unet_lora, text_lora
    run_log = {"save_ms": [], "restore_ms": None, "resumed_at": None}
    if args.full_state_checkpoint_dir:
        ckpt = ckpt_lib.latest_checkpoint(args.full_state_checkpoint_dir)
        if ckpt:
            print(f"Resuming full train state from {ckpt}")
            t0 = time.perf_counter()
            state = ckpt_lib.restore_train_state(ckpt, state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            run_log["restore_ms"] = (time.perf_counter() - t0) * 1e3
    tp_lib.shard_models(mesh, pipe.unet, pipe.text_encoder)
    if mesh is not None:
        state = mesh_lib.shard_tree(state, mesh_lib.tp_state_shardings(mesh, state), mesh)
    params = state["params"]

    dispatcher = FusedDispatcher(step_fn, spd=spd, mesh=mesh, cuda_graphs=mesh_graphs(mesh))

    total_batch = (args.train_batch_size * mesh_lib.process_count()
                   * args.gradient_accumulation_steps)
    print("***** Running training *****")
    print(f"  Num examples = {len(train_dataset)}")
    print(f"  Num Epochs = {num_train_epochs}")
    print(f"  Instantaneous batch size per device = {args.train_batch_size}")
    print(f"  Total train batch size (w. parallel, distributed & accumulation) = {total_batch}")
    print(f"  Gradient Accumulation steps = {args.gradient_accumulation_steps}")
    print(f"  Total optimization steps = {args.max_train_steps}")

    os.makedirs(args.output_dir, exist_ok=True)
    global_step = int(state["step"])
    last_save = global_step
    if global_step:
        print(f"Resumed at step {global_step}")
        run_log["resumed_at"] = global_step

    # loss/lr scalars to tensorboard (reference: accelerator.log,
    # train_lora_dreambooth.py:959-961) and rolling step-time statistics
    logger = MetricLogger(log_dir=os.path.join(args.output_dir, args.logging_dir)
                          if mesh_lib.is_main_process() else None)
    timer = StepTimer()
    lr_now = lr_schedule(args.lr_scheduler, lr, args.lr_warmup_steps, args.max_train_steps)

    def save_periodic(epoch, step):
        filename_unet = f"{args.output_dir}/lora_weight_e{epoch}_s{step}.pt"
        print(f"save weights {filename_unet}")
        lora_lib.save_lora_weight(params["unet_lora"], unet_targets, filename_unet)
        if args.train_text_encoder:
            lora_lib.save_lora_weight(
                params["text_lora"], text_targets,
                f"{args.output_dir}/lora_weight_e{epoch}_s{step}.text_encoder.pt")

    latent_cache = None
    if args.cache_latents:
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
        take = min(spd, args.max_train_steps - gs)
        group = []
        for epoch, batch in stream:
            stream_epoch[0] = epoch
            group.append(batch)
            if len(group) == take:
                break
        return group

    log = DispatchLog("dreambooth", dev)
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
            logger.log({"loss": loss, "lr": float(lr_now(global_step)),
                        "steps_per_sec": timer.steps_per_sec}, global_step)
        if (args.save_steps and global_step - last_save >= args.save_steps
                and mesh_lib.is_main_process()):
            save_periodic(epoch, global_step)
            if args.full_state_checkpoint_dir:
                t0 = time.perf_counter()
                ckpt_lib.save_train_state(args.full_state_checkpoint_dir, state,
                                          step=global_step)
                run_log["save_ms"].append((time.perf_counter() - t0) * 1e3)
            last_save = global_step
        log.resume()

    mesh_lib.barrier("end of training")
    logger.close()
    run_log["dispatch"] = log.summary()
    del dispatcher, step_fn
    gc.collect()
    print("\n\nLora TRAINING DONE!\n\n")

    if not mesh_lib.is_main_process():
        state["log"] = run_log
        return state
    if args.output_format in ("pt", "both"):
        lora_lib.save_lora_weight(params["unet_lora"], unet_targets,
                                  args.output_dir + "/lora_weight.pt")
        if args.train_text_encoder:
            lora_lib.save_lora_weight(params["text_lora"], text_targets,
                                      args.output_dir + "/lora_weight.text_encoder.pt")
    if args.output_format in ("safe", "both"):
        modelmap = {"unet": (host_tree(params["unet_lora"]), unet_targets,
                             lora_lib.UNET_DEFAULT_TARGET_REPLACE)}
        if args.train_text_encoder:
            modelmap["text_encoder"] = (host_tree(params["text_lora"]), text_targets,
                                        lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
        lora_lib.save_safeloras(modelmap, args.output_dir + "/lora_weight.safetensors")
    state["log"] = run_log
    return state


if __name__ == "__main__":
    main(parse_args())
