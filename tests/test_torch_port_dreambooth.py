"""The port's DreamBooth trainer against the JAX package's, on the CPU, at
the tiny configs in fp32 and 16x16 pixels: ``train_lora_dreambooth.main``
with prior preservation and the text LoRA, warm-started from ``.pt`` files
(``--resume_unet``/``--resume_text_encoder``, non-zero up), 3 steps.

JAX's per-step draws are handed to the port through
``FusedDispatcher.drive(draws=)``; JAX runs one step a dispatch, the port
two and then a one-step tail.  Tolerances: losses 1e-5 relative;
parameters within ``TRAINER_ATOL`` (2%) of the LR for each update
(``tests/torch_port_fixtures.py``); the output files hold JAX's names,
metadata and dtypes, ``.pt`` values within one fp16 rounding more.
"""

import os
import sys

import jax
import numpy as np
import torch

from diffusion_finetuning_tpu import lora as jlora

from tests.torch_port_fixtures import (assert_params_close, assert_same_safetensors, flat_lora,
                                       given_draws_dispatcher, numpy_lora_tree,
                                       recording_dispatcher, step_keys, to_jax, trainer_dirs,
                                       trainer_draws)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dreambooth_matches_jax(tmp_path_factory, monkeypatch):
    from diffusion_finetuning_tpu.models import clip_text as jclip
    from diffusion_finetuning_tpu.models import unet as junet

    from diffusion_finetuning_tpu_torch.training_scripts import train_lora_dreambooth as tdb

    sys.path.insert(0, os.path.join(REPO, "training_scripts"))
    try:
        import train_lora_dreambooth as jdb
    finally:
        sys.path.remove(os.path.join(REPO, "training_scripts"))

    dirs = trainer_dirs(tmp_path_factory)
    ucfg, tcfg = junet.UNetConfig.tiny(), jclip.CLIPTextConfig.tiny()
    unet_targets = jlora.filter_targets(junet.unet_lora_targets(ucfg),
                                        jlora.DEFAULT_TARGET_REPLACE)
    text_targets = jclip.text_encoder_lora_targets(tcfg)
    resume_u, resume_t = (str(dirs["root"] / n) for n in ("resume_u.pt", "resume_t.pt"))
    jlora.save_lora_weight(to_jax(numpy_lora_tree(unet_targets, rank=2, seed=2, amp=0.05)),
                           unet_targets, resume_u)
    jlora.save_lora_weight(to_jax(numpy_lora_tree(text_targets, rank=2, seed=3, amp=0.05)),
                           text_targets, resume_t)
    lr, lr_text, steps = 1e-3, 1e-3, 3

    def args(out, spd):
        return [
            "--pretrained_model_name_or_path", dirs["model"],
            "--instance_data_dir", dirs["inst"], "--instance_prompt", "a photo of sks",
            "--with_prior_preservation", "--class_data_dir", dirs["cls"],
            "--class_prompt", "a photo", "--num_class_images", "2",
            "--output_dir", str(dirs["root"] / out), "--resolution", "16",
            "--train_batch_size", "1", "--max_train_steps", str(steps), "--save_steps", "2",
            "--lora_rank", "2", "--train_text_encoder", "--learning_rate", str(lr),
            "--learning_rate_text", str(lr_text), "--seed", "5", "--output_format", "both",
            "--resume_unet", resume_u, "--resume_text_encoder", resume_t,
            "--steps_per_dispatch", str(spd)]

    jlosses = []
    with monkeypatch.context() as m:
        m.setattr(jdb, "FusedDispatcher", recording_dispatcher(jlosses))
        jstate = jdb.main(jdb.parse_args(args("jax_db", 1)))

    # main splits PRNGKey(seed) three ways before the loop (k1, k2 unused here)
    rng, _, _ = jax.random.split(jax.random.PRNGKey(5), 3)
    keys = step_keys(rng, steps)
    monkeypatch.setattr(tdb, "FusedDispatcher",
                        given_draws_dispatcher([lambda s: trainer_draws(keys[s], 2, 1000)]))
    tstate = tdb.main(tdb.parse_args(args("port_db", 2)), device="cpu")

    np.testing.assert_allclose(tstate["log"]["dispatch"]["losses"], np.concatenate(jlosses),
                               rtol=1e-5)
    assert tstate["step"] == int(jstate["step"]) == steps
    for key, targets, group_lr in (("unet_lora", unet_targets, lr),
                                   ("text_lora", text_targets, lr_text)):
        assert_params_close(flat_lora(tstate["params"][key], targets),
                            flat_lora(jstate["params"][key], targets), group_lr, steps)

    out_t, out_j = dirs["root"] / "port_db", dirs["root"] / "jax_db"
    files = sorted(f for f in os.listdir(out_j) if f != "logs")
    assert sorted(f for f in os.listdir(out_t) if f != "logs") == files
    assert "lora_weight_e1_s2.pt" in files and "lora_weight.text_encoder.pt" in files
    assert_same_safetensors(str(out_t / "lora_weight.safetensors"),
                            str(out_j / "lora_weight.safetensors"), lr, steps)
    for name in (f for f in files if f.endswith(".pt")):
        got = torch.load(out_t / name, weights_only=True)
        want = torch.load(out_j / name, weights_only=True)
        assert [t.dtype for t in got] == [t.dtype for t in want] == [torch.float16] * len(want)
        # fp16 files: one fp16 rounding step more than the fp32 bound
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=2 ** -10,
                                       atol=2e-2 * lr * steps)
