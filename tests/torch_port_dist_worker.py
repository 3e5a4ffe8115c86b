"""One rank of the port's multi-device CPU tests (tests/test_torch_port_parallel.py).

Run as ``python -m tests.torch_port_dist_worker --rank R --world N --init
file:///... --inputs INPUTS.pkl --out DIR``: it joins a gloo group, runs
every scenario in turn -- each is collective, so every rank runs them in
the same order -- and writes ``DIR/rank{R}.npz``.  It imports no JAX: its
inputs (the tiny pipe's directory, LoRA trees, batches and JAX's draws)
come from the test process in one pickle.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from diffusion_finetuning_tpu_torch import serving
from diffusion_finetuning_tpu_torch.models import weights
from diffusion_finetuning_tpu_torch.models.schedulers import DDPMScheduler
from diffusion_finetuning_tpu_torch.parallel import mesh as mesh_lib
from diffusion_finetuning_tpu_torch.parallel import tp as tp_lib
from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline
from diffusion_finetuning_tpu_torch.training import optim
from diffusion_finetuning_tpu_torch.training import train_step as ttrain

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# the DP step's hyper-parameters (the test builds JAX's with the same)
LR, MAX_NORM, PRIOR_W = 1e-3, 0.05, 0.7
# txt2img requests of the shard_over and serving scenarios
REQ = dict(height=16, width=16, num_inference_steps=2, guidance_scale=7.5)
PROMPTS = ["a photo of sks", "photo", "a photo", "sks of photo"]


def flat(tree) -> np.ndarray:
    return np.concatenate([t.detach().reshape(-1).numpy()
                           for t in optim.trainable_tensors(tree)])


def load_pipe(inp):
    return StableDiffusionPipeline.from_pretrained(inp["model"], device="cpu")


def train_run(inp, pipe, mesh, batch, draws, prior, steps, text=True):
    """``steps`` train steps through FusedDispatcher (spd 1) from the given
    LoRA trees: (losses, flat parameters after each step)."""
    groups = {"unet_lora": optim.ParamGroup(lr=LR)}
    if text:
        groups["text_lora"] = optim.ParamGroup(lr=LR)
    opt = optim.multi_group_optimizer(groups, max_grad_norm=MAX_NORM)
    step = ttrain.build_train_step(
        unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae,
        scheduler=DDPMScheduler(pipe.scheduler_config), optimizer=opt,
        partition=ttrain.TrainablePartition(unet_lora=True, text_lora=text),
        with_prior_preservation=prior, prior_loss_weight=PRIOR_W)
    state = ttrain.init_train_state(
        opt, unet_lora=weights.lora_tree_to_torch(inp["unet_lora"]),
        text_lora=weights.lora_tree_to_torch(inp["text_lora"]) if text else None,
        device="cpu")
    if mesh is not None:
        state = mesh_lib.shard_tree(state, mesh_lib.tp_state_shardings(mesh, state), mesh)
    disp = ttrain.FusedDispatcher(step, 1, mesh=mesh)
    losses, params = [], []
    for s in range(steps):
        state, loss = disp.run(state, [batch], draws=[draws[s]])
        losses.append(float(loss[0]))
        params.append(flat(state["params"]))
    return np.array(losses), np.stack(params)


def scenario_dp(inp, out):
    """data=2: prior preservation and a face mask, against JAX's mesh step
    and the one-process step (in the test); then two nodes of one rank each
    (LOCAL_WORLD_SIZE=1), where the global batch is both nodes' batches."""
    pipe = load_pipe(inp)
    mesh = mesh_lib.make_mesh(2)
    out["dp_loss"], out["dp_params"] = train_run(inp, pipe, mesh, inp["dp_batch"],
                                                 inp["dp_draws"], True, 2)
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        assert mesh_lib.process_count() == 2 and mesh_lib.local_batch_size(4) == 2
        out["nodes_loss"], out["nodes_params"] = train_run(
            inp, pipe, mesh, inp["dp_batch"], inp["nodes_draws"], True, 1)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]


def scenario_tp(inp, out):
    """tp=2 UNet and CLIP forwards and a train step, each against the same
    run unsplit on this rank; the launch counts' stand-in on the CPU: the
    split layers' shapes."""
    ref, pipe = load_pipe(inp), load_pipe(inp)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    t = torch.tensor([981, 3])
    ids = torch.from_numpy(inp["tp_batch"]["input_ids"]).long()
    ulora = weights.lora_tree_to_torch(inp["unet_lora"])
    tlora = weights.lora_tree_to_torch(inp["text_lora"])
    from diffusion_finetuning_tpu_torch.lora import attached

    def forwards(p):
        with torch.no_grad(), attached(p.text_encoder, tlora):
            ctx = p.text_encoder(ids)
        with torch.no_grad(), attached(p.unet, ulora):
            eps = p.unet(x, t, ctx)
        return ctx.numpy(), eps.numpy()

    out["tp_ref_ctx"], out["tp_ref_eps"] = forwards(ref)
    out["tp_ref_loss"], out["tp_ref_params"] = train_run(
        inp, ref, None, inp["tp_batch"], inp["tp_draws"], False, 2)
    mesh = mesh_lib.make_mesh(2, ("data", "tp"), (1, 2))
    tp_lib.shard_models(mesh, pipe.unet, pipe.text_encoder)
    names = tp_lib.split_layers(pipe.unet) + tp_lib.split_layers(pipe.text_encoder)
    out["tp_split_layers"] = np.array(len(names))
    q = pipe.unet.get_submodule(
        "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q").weight
    out["tp_q_shape"] = np.array(q.shape)
    out["tp_ctx"], out["tp_eps"] = forwards(pipe)
    out["tp_loss"], out["tp_params"] = train_run(
        inp, pipe, mesh, inp["tp_batch"], inp["tp_draws"], False, 2)


def scenario_shard_over(inp, out):
    """txt2img and img2img over data=2 and tp=2 against the unsharded pipe,
    and shard_over(None) back to it."""
    pipe = load_pipe(inp)
    ref = pipe(PROMPTS, seed=7, output_type="uint8", **REQ)
    init = (np.random.default_rng(4).random((16, 16, 3)) * 255).astype(np.uint8)
    i2i = dict(strength=0.6, num_inference_steps=3, seed=2, output_type="uint8")
    ref_i2i = pipe.img2img(PROMPTS[:2], init, **i2i)
    out["so_ref"], out["so_ref_i2i"] = ref, ref_i2i
    pipe.shard_over(mesh_lib.make_mesh(2))
    out["so_data"] = pipe(PROMPTS, seed=7, output_type="uint8", **REQ)
    out["so_data_i2i"] = pipe.img2img(PROMPTS[:2], init, **i2i)
    try:
        pipe(PROMPTS[:3], seed=7, **REQ)
        out["so_odd_raised"] = np.array(False)
    except ValueError as e:
        out["so_odd_raised"] = np.array("multiple of the mesh data axis" in str(e))
    pipe.shard_over(mesh_lib.make_mesh(2, ("data", "tp"), (1, 2)))
    out["so_tp"] = pipe(PROMPTS, seed=7, output_type="uint8", **REQ)
    pipe.shard_over(None)
    out["so_back"] = pipe(PROMPTS, seed=7, output_type="uint8", **REQ)
    # an installed LoRA, merged (each rank merges its shard) and dynamic
    pipe.unet_lora = weights.lora_tree_to_torch(inp["unet_lora"])
    for mode, merged in (("merged", True), ("dynamic", False)):
        pipe.materialize_lora = merged
        out[f"so_ref_{mode}"] = pipe(PROMPTS[:2], seed=3, output_type="uint8", **REQ)
    pipe.shard_over(mesh_lib.make_mesh(2, ("data", "tp"), (1, 2)))
    for mode, merged in (("merged", True), ("dynamic", False)):
        pipe.materialize_lora = merged
        out[f"so_tp_{mode}"] = pipe(PROMPTS[:2], seed=3, output_type="uint8", **REQ)
    pipe.shard_over(None)


def scenario_serving(inp, out):
    """Rank 0 serves three requests and one with an adapter on a data=2
    pipe; the other rank follows.  The ladder is rounded up to multiples of
    2."""
    pipe = load_pipe(inp)
    adapter = {"unet_lora": weights.lora_tree_to_torch(inp["unet_lora"])}
    ref = pipe(PROMPTS[:3], seed=[11, 12, 13], output_type="uint8", **REQ)
    ref_a = pipe(PROMPTS[3], seed=14, output_type="uint8",
                 adapter_params=pipe.adapter_generation_params(**adapter), **REQ)
    pipe.shard_over(mesh_lib.make_mesh(2))
    if mesh_lib.is_main_process():
        server = serving.GenerationServer(pipe, max_batch=4, max_wait_ms=200.0)
        server.register_adapter("a", adapter)
        out["srv_ladder"] = np.array(server.allowed_batches)
        req = dict(height=16, width=16, steps=2, guidance_scale=7.5, scheduler="ddim")
        futs = [server.submit(p, seed=s, **req) for p, s in zip(PROMPTS[:3], (11, 12, 13))]
        futs.append(server.submit(PROMPTS[3], seed=14, adapter="a", **req))
        out["srv_images"] = np.stack([np.asarray(f.result(timeout=300)) for f in futs])
        server.close()
        out["srv_calls"] = np.array(-1)
    else:
        out["srv_calls"] = np.array(serving.follow(pipe, adapters={"a": adapter}))
    out["srv_ref"] = np.concatenate([ref, ref_a])


def scenario_processes(inp, out):
    rank = torch.distributed.get_rank()
    out["main"] = np.array(mesh_lib.is_main_process())
    out["local_batch"] = np.array(mesh_lib.local_batch_size(4))
    part = mesh_lib.shard_batch({"x": np.arange(8).reshape(4, 2), "y": np.zeros((2, 4))},
                                mesh_lib.make_mesh(2), spec=(None, "data"))
    out["shard_x"], out["shard_y"] = part["x"].numpy(), part["y"].numpy()
    t0 = time.monotonic()
    if rank == 1:
        time.sleep(0.5)
    mesh_lib.coordination_barrier("dist-test")
    mesh_lib.barrier("dist-test")
    out["barrier_wait_s"] = np.array(time.monotonic() - t0)


def db_args(inp, out):
    """DreamBooth at 16^2 with prior preservation and the text LoRA, 2 steps:
    ``data`` = 2 over two ranks (one example a rank)."""
    return ["--pretrained_model_name_or_path", inp["model"], "--instance_data_dir", inp["inst"],
            "--instance_prompt", "a photo of sks", "--with_prior_preservation",
            "--class_data_dir", inp["cls"], "--class_prompt", "a photo",
            "--num_class_images", "2", "--resolution", "16", "--train_batch_size", "1",
            "--max_train_steps", "2", "--save_steps", "2", "--lora_rank", "2",
            "--train_text_encoder", "--learning_rate", str(LR), "--learning_rate_text", str(LR),
            "--seed", "5", "--output_dir", out]


def wti_args(inp, out):
    """train_lora_w_ti at 16^2 with prior preservation, 2 steps over a LoRA
    unfreeze at step 1: ``data`` = 2."""
    return ["--pretrained_model_name_or_path", inp["model"], "--instance_data_dir", inp["inst"],
            "--placeholder_token", "<krk>", "--initializer_token", "photo",
            "--with_prior_preservation", "--class_data_dir", inp["cls"],
            "--class_prompt", "a photo", "--num_class_images", "2", "--resolution", "16",
            "--train_batch_size", "1",
            "--max_train_steps", "2", "--save_steps", "2", "--lora_rank", "2",
            "--unfreeze_lora_step", "1", "--learning_rate", str(LR),
            "--learning_rate_text", str(LR), "--learning_rate_ti", str(LR), "--seed", "5",
            "--output_dir", out]


def pti_kwargs(inp, out):
    """lora_pti at 16^2, 2 inversion and 2 tuning steps with the text LoRA:
    run with ``tensor_parallel=2``."""
    return dict(instance_data_dir=inp["inst"], pretrained_model_name_or_path=inp["model"],
                use_template="object", placeholder_tokens="<s1>|<s2>",
                initializer_tokens="<rand-0.5>|<zero>", seed=7, resolution=16,
                train_batch_size=1, max_train_steps_ti=2, max_train_steps_tuning=2,
                save_steps=2, lora_rank=2, train_text_encoder=True, continue_inversion=True,
                learning_rate_unet=LR, learning_rate_text=LR, learning_rate_ti=5 * LR,
                mixed_precision="no", output_dir=out)


def trainer_results(kind, inp, out_dir, **kw):
    """(losses, flat trained tensors) of one trainer run on this process."""
    from diffusion_finetuning_tpu_torch import cli_lora_pti
    from diffusion_finetuning_tpu_torch.training.trainer_util import token_table
    from diffusion_finetuning_tpu_torch.training_scripts import (train_lora_dreambooth,
                                                                 train_lora_w_ti)

    if kind == "pti":
        pipe = cli_lora_pti.train(device="cpu", **pti_kwargs(inp, out_dir), **kw)
        losses = np.concatenate([p["losses"] for p in pipe.train_log])
        return losses, np.concatenate([flat(pipe.unet_lora), flat(pipe.text_encoder_lora),
                                       token_table(pipe).detach().float().reshape(-1).numpy()])
    module, args = ((train_lora_dreambooth, db_args) if kind == "dreambooth"
                    else (train_lora_w_ti, wti_args))
    state = module.main(module.parse_args(args(inp, out_dir)), device="cpu")
    return np.asarray(state["log"]["dispatch"]["losses"]), flat(state["params"])


def scenario_trainers(inp, out):
    """The trainers through their entry points on both ranks: DreamBooth and
    w_ti with ``data`` = 2, lora_pti with ``tensor_parallel=2``; the test
    runs each in one process."""
    rank = torch.distributed.get_rank()
    for kind in ("dreambooth", "w_ti", "pti"):
        kw = {"tensor_parallel": 2} if kind == "pti" else {}
        out[f"{kind}_loss"], out[f"{kind}_params"] = trainer_results(
            kind, inp, os.path.join(inp["root"], f"{kind}{rank}"), **kw)


SCENARIOS = (scenario_processes, scenario_dp, scenario_tp, scenario_shard_over,
             scenario_serving, scenario_trainers)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    mesh_lib.initialize_distributed(args.init, args.world, args.rank, device="cpu")
    with open(args.inputs, "rb") as f:
        inp = pickle.load(f)
    out = {}
    for fn in SCENARIOS:
        t0 = time.perf_counter()
        fn(inp, out)
        out[f"seconds_{fn.__name__}"] = np.array(time.perf_counter() - t0)
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
