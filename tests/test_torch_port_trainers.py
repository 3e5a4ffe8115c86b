"""The port's PTI trainer against the JAX package's, on the CPU, at the
tiny configs in fp32 and 16x16 pixels: ``cli_lora_pti.train`` (2 inversion
steps with gradient accumulation 2, then 2 tuning steps with the text LoRA
and continued inversion) from one model directory and one image folder
(``test_torch_port_dreambooth.py`` holds DreamBooth the same way).

What cannot be reproduced in torch is handed across: the initial LoRA trees
(JAX's freshly injected trees, handed to the port's
``inject_trainable_lora``), and every step's random draws, computed from the
keys JAX's ``FusedDispatcher.drive`` splits and handed to the port through
``FusedDispatcher.drive(draws=)`` as ``test_torch_port_multistep.py`` does.
JAX runs one step a dispatch, the port two: the grouping must not change
the result.

Tolerances: losses 1e-5 relative, as ``test_torch_port_training.py``;
parameters within ``TRAINER_ATOL`` (2%) of their group's LR for each
update taken (``tests/torch_port_fixtures.py`` says why).  The checkpoint
files hold the same tensor names and metadata as JAX's, their values
within the same bounds.
"""

import os

import jax
import numpy as np
import pytest

from diffusion_finetuning_tpu import lora as jlora

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.models import weights

from tests.torch_port_fixtures import (assert_params_close, assert_same_safetensors, flat_lora,
                                       given_draws_dispatcher, recording_dispatcher, step_keys,
                                       to_numpy, trainer_dirs, trainer_draws)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return trainer_dirs(tmp_path_factory)


def test_lora_pti_matches_jax(dirs, monkeypatch):
    from diffusion_finetuning_tpu import cli_lora_pti as jpti
    from diffusion_finetuning_tpu.models import clip_text as jclip
    from diffusion_finetuning_tpu.models import unet as junet

    from diffusion_finetuning_tpu_torch import cli_lora_pti as tpti
    from diffusion_finetuning_tpu_torch.training.trainer_util import token_table

    seed, lr_unet, lr_text, lr_ti = 7, 1e-3, 1e-3, 5e-3
    kw = dict(instance_data_dir=dirs["inst"], pretrained_model_name_or_path=dirs["model"],
              use_template="object", placeholder_tokens="<s1>|<s2>",
              initializer_tokens="<rand-0.5>|<zero>", seed=seed, resolution=16,
              train_batch_size=1, max_train_steps_ti=2, max_train_steps_tuning=2,
              save_steps=2, gradient_accumulation_steps=2, lora_rank=2,
              train_text_encoder=True, continue_inversion=True, mixed_precision="no",
              learning_rate_unet=lr_unet, learning_rate_text=lr_text, learning_rate_ti=lr_ti)

    injected, jlosses = [], []
    real_inject = jlora.inject_trainable_lora

    def record(*a, **k):
        injected.append(real_inject(*a, **k))
        return injected[-1]

    with monkeypatch.context() as m:
        m.setattr(jlora, "inject_trainable_lora", record)
        m.setattr(jpti, "FusedDispatcher", recording_dispatcher(jlosses))
        jpipe = jpti.train(output_dir=str(dirs["root"] / "jax_pti"), **kw)

    # phase 1 drives from PRNGKey(seed); phase 2 after two splits for the inits
    rng = jax.random.PRNGKey(seed)
    ti_keys = step_keys(rng, 2)
    rng, _ = jax.random.split(rng)
    rng, _ = jax.random.split(rng)
    tune_keys = step_keys(rng, 2)
    phase_draws = [lambda s: trainer_draws(ti_keys[s], 1, 1000),
                   lambda s: trainer_draws(tune_keys[s], 1, 800)]
    trees = iter(weights.lora_tree_to_torch(to_numpy(t)) for t in injected)
    monkeypatch.setattr(tlora, "inject_trainable_lora", lambda *a, **k: next(trees))
    monkeypatch.setattr(tpti, "FusedDispatcher", given_draws_dispatcher(phase_draws))
    tpipe = tpti.train(output_dir=str(dirs["root"] / "port_pti"), steps_per_dispatch=2,
                       device="cpu", **kw)

    got = np.concatenate([p["losses"] for p in tpipe.train_log])
    np.testing.assert_allclose(got, np.concatenate(jlosses), rtol=1e-5)
    assert [p["steps"] for p in tpipe.train_log] == [2, 2]
    assert tpipe.train_log[0]["frozen_rows_changed"] == 0

    ucfg, tcfg = junet.UNetConfig.tiny(), jclip.CLIPTextConfig.tiny()
    unet_targets = jlora.filter_targets(junet.unet_lora_targets(ucfg),
                                        jlora.UNET_DEFAULT_TARGET_REPLACE)
    text_targets = jclip.text_encoder_lora_targets(tcfg)
    assert_params_close(flat_lora(tpipe.unet_lora, unet_targets),
                        flat_lora(jpipe.unet_lora, unet_targets), lr_unet, 2)
    assert_params_close(flat_lora(tpipe.text_encoder_lora, text_targets),
                        flat_lora(jpipe.text_encoder_lora, text_targets), lr_text, 2)
    # the whole table: one inversion update and two unconstrained tuning ones
    assert_params_close([token_table(tpipe).numpy()],
                        [np.asarray(jpipe.text_params["token_embedding"]["embedding"])],
                        lr_ti, 3)
    assert tpipe.tokenizer.convert_tokens_to_ids("<s2>") == \
        jpipe.tokenizer.convert_tokens_to_ids("<s2>")

    out_t, out_j = dirs["root"] / "port_pti", dirs["root"] / "jax_pti"
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == [
        "step_2.safetensors", "step_inv_2.safetensors"]
    assert_same_safetensors(str(out_t / "step_inv_2.safetensors"),
                            str(out_j / "step_inv_2.safetensors"), lr_ti, 1)
    assert_same_safetensors(str(out_t / "step_2.safetensors"), str(out_j / "step_2.safetensors"),
                            max(lr_unet, lr_ti), 3)

    img = tpipe("a photo of <s1> <s2>", num_inference_steps=2, height=16, width=16,
                output_type="np")
    assert img.shape == (1, 16, 16, 3) and np.isfinite(img).all()
