"""The port's joint LoRA + TI trainers against the JAX package's, on the
CPU, at the tiny configs in fp32 and 16x16 pixels: ``train_lora_w_ti.main``
(template captions) and ``train_lora_pt_caption.main`` (filename-stem
captions, ``.pt`` files only), 3 steps with the LoRA unfrozen at step 1.
The port runs two steps a dispatch, so its first fused group straddles the
unfreeze step: step 0 trains the embeddings only, steps 1-2 the LoRA only.

Both packages start from the same LoRA trees (non-zero up, handed to each
package's ``inject_trainable_lora``), and JAX's per-step draws are handed to
the port through ``FusedDispatcher.drive(draws=)``.

Tolerances: losses 1e-5 relative; LoRA and embeddings within
``TRAINER_ATOL`` (2%) of their group's LR for each update taken
(``tests/torch_port_fixtures.py``); the frozen rows of the token table
bit-equal to JAX's; the output files hold JAX's names, the ``.pt`` values
within one fp16 rounding more.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu import lora as jlora

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.models import weights

from tests.torch_port_fixtures import (assert_params_close, assert_same_safetensors, flat_lora,
                                       given_draws_dispatcher, numpy_lora_tree,
                                       recording_dispatcher, step_keys, to_jax, trainer_dirs,
                                       trainer_draws)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "<krk>"


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The trainer inputs plus an instance folder whose file stems hold the
    placeholder, so that pt_caption's captions train its row."""
    from PIL import Image

    dirs = trainer_dirs(tmp_path_factory)
    inst = dirs["root"] / "ti_inst"
    inst.mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        arr = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(inst / f"a photo of {TOKEN} {i}.png")
    return {**dirs, "ti_inst": str(inst)}


def _import_jax_script(name):
    sys.path.insert(0, os.path.join(REPO, "training_scripts"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(os.path.join(REPO, "training_scripts"))


@pytest.mark.parametrize("script", ["train_lora_w_ti", "train_lora_pt_caption"])
def test_ti_trainer_matches_jax(script, dirs, monkeypatch):
    import importlib

    from diffusion_finetuning_tpu.models import clip_text as jclip
    from diffusion_finetuning_tpu.models import unet as junet

    from diffusion_finetuning_tpu_torch.training_scripts import train_lora_w_ti as twti

    jscript = _import_jax_script(script)
    jwti = sys.modules["train_lora_w_ti"]  # pt_caption runs w_ti's main
    tscript = importlib.import_module(f"diffusion_finetuning_tpu_torch.training_scripts.{script}")

    ucfg, tcfg = junet.UNetConfig.tiny(), jclip.CLIPTextConfig.tiny()
    unet_targets = jlora.filter_targets(junet.unet_lora_targets(ucfg),
                                        jlora.DEFAULT_TARGET_REPLACE)
    text_targets = jlora.filter_targets(jclip.text_encoder_lora_targets(tcfg),
                                        jlora.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
    trees = [numpy_lora_tree(unet_targets, rank=2, seed=4, amp=0.05),
             numpy_lora_tree(text_targets, rank=2, seed=5, amp=0.05)]
    lr, lr_text, lr_ti, steps, seed = 1e-3, 1e-3, 5e-3, 3, 9

    def args(out, spd):
        return [
            "--pretrained_model_name_or_path", dirs["model"],
            "--instance_data_dir", dirs["ti_inst"], "--placeholder_token", TOKEN,
            "--initializer_token", "sks", "--output_dir", str(dirs["root"] / out),
            "--resolution", "16", "--train_batch_size", "1", "--max_train_steps", str(steps),
            "--save_steps", "2", "--steps_per_dispatch", str(spd),
            "--unfreeze_lora_step", "1", "--lr_warmup_steps", "0", "--lora_rank", "2",
            "--learning_rate", str(lr), "--learning_rate_text", str(lr_text),
            "--learning_rate_ti", str(lr_ti), "--seed", str(seed)]

    jlosses = []
    with monkeypatch.context() as m:
        given = iter(trees)
        m.setattr(jlora, "inject_trainable_lora", lambda *a, **k: to_jax(next(given)))
        m.setattr(jwti, "FusedDispatcher", recording_dispatcher(jlosses))
        jstate = jscript.main(jscript.parse_args(args(f"jax_{script}", 1)))

    # main splits PRNGKey(seed) three ways before the loop (k1, k2: the LoRA inits)
    rng, _, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    keys = step_keys(rng, steps)
    given = iter(trees)
    monkeypatch.setattr(tlora, "inject_trainable_lora",
                        lambda *a, **k: weights.lora_tree_to_torch(next(given)))
    monkeypatch.setattr(twti, "FusedDispatcher",
                        given_draws_dispatcher([lambda s: trainer_draws(keys[s], 1, 1000)]))
    tstate = tscript.main(tscript.parse_args(args(f"port_{script}", 2)), device="cpu")

    np.testing.assert_allclose(tstate["log"]["dispatch"]["losses"], np.concatenate(jlosses),
                               rtol=1e-5)
    assert tstate["log"]["dispatch"]["steps"] == steps
    for key, targets, group_lr in (("unet_lora", unet_targets, lr),
                                   ("text_lora", text_targets, lr_text)):
        got = flat_lora(tstate["params"][key], targets)
        assert_params_close(got, flat_lora(jstate["params"][key], targets), group_lr, 2)
        assert any(not np.array_equal(g, w) for g, w in zip(got, flat_lora(
            trees[0] if key == "unet_lora" else trees[1], targets)))  # the LoRA moved

    table = tstate["params"]["ti_embeddings"].detach().numpy()
    jtable = np.asarray(jstate["params"]["ti_embeddings"])
    row = len(table) - 1  # the placeholder, appended to the vocabulary
    assert table.shape == jtable.shape
    np.testing.assert_array_equal(table[:row], jtable[:row])  # frozen rows restored
    assert_params_close([table[row]], [jtable[row]], lr_ti, 1)
    # the row trained: it no longer equals its initializer's (or any) row
    assert not (table[:row] == table[row]).all(axis=1).any()

    out_t, out_j = dirs["root"] / f"port_{script}", dirs["root"] / f"jax_{script}"
    files = sorted(f for f in os.listdir(out_j) if f != "logs")
    assert sorted(f for f in os.listdir(out_t) if f != "logs") == files
    assert "lora_weight.ti.pt" in files and any(f.endswith("_s2.ti.pt") for f in files)
    assert ("lora_weight.safetensors" in files) == (script == "train_lora_w_ti")
    if script == "train_lora_w_ti":
        assert_same_safetensors(str(out_t / "lora_weight.safetensors"),
                                str(out_j / "lora_weight.safetensors"), max(lr, lr_ti), 2)
    for name in (f for f in files if f.endswith(".pt")):
        got = torch.load(out_t / name, weights_only=True)
        want = torch.load(out_j / name, weights_only=True)
        if name.endswith(".ti.pt"):
            assert list(got) == list(want) == [TOKEN]
            assert got[TOKEN].dtype == want[TOKEN].dtype
            assert_params_close([got[TOKEN].numpy()], [want[TOKEN].numpy()], lr_ti, 1)
            continue
        assert [t.dtype for t in got] == [t.dtype for t in want] == [torch.float16] * len(want)
        # fp16 files: one fp16 rounding step more than the fp32 bound
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=2 ** -10,
                                       atol=2e-2 * lr * 2)
