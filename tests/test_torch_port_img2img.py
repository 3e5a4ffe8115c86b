"""The port's img2img with every sampler, and stochastic DDIM, against the
JAX package on the CPU.

Both pipelines read the same tiny diffusers directory (the port's tiny
pipe, written by ``save_pretrained``); the port is handed JAX's draws: the
posterior sample and forward noise from ``split(PRNGKey(seed))`` and, for
Euler-ancestral, the per-step noise of the keys JAX folds from
``fold_in(key, 7)``.  Images agree within 1/255 + 1e-6 (the same fp32 value
may round to neighbouring uint8 levels), the rule of
``test_torch_port_pipeline.py::test_img2img_matches_jax``; a DDIM step with
eta > 0 and JAX's noise handed in agrees to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu.models import schedulers as jsched
from diffusion_finetuning_tpu.pipelines.pipeline import StableDiffusionPipeline as JaxPipe

from diffusion_finetuning_tpu_torch.models import schedulers as tsched
from diffusion_finetuning_tpu_torch.pipelines.pipeline import (StableDiffusionPipeline,
                                                               img2img_start)

from tests.torch_port_fixtures import trainer_dirs

PROMPTS = ["a photo of sks", "photo"]
SCHEDULERS = ["ddim", "pndm", "dpm", "euler", "euler_a", "lms", "euler:karras",
              "euler_a:karras", "lms:karras"]
STEPS, STRENGTH, SEED = 4, 0.6, 3


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """Both packages' pipes read from one directory: the port's tiny pipe
    written with ``save_pretrained`` (no JAX model init to compile)."""
    model = trainer_dirs(tmp_path_factory)["model"]
    return (JaxPipe.from_pretrained(model),
            StableDiffusionPipeline.from_pretrained(model, device="cpu"))


def _init_image():
    return np.random.default_rng(5).integers(0, 256, (16, 16, 3), dtype=np.uint8)


def jax_draws(seed, batch, used, ancestral):
    """JAX's img2img draws (pipeline :870-913) in the port's NHWC layout."""
    key = jax.random.PRNGKey(seed)
    r_enc, r_noise = jax.random.split(key)
    out = {"sample": np.asarray(jax.random.normal(r_enc, (1, 8, 8, 4), jnp.float32)),
           "noise": np.asarray(jax.random.normal(r_noise, (batch, 8, 8, 4), jnp.float32))}
    if ancestral:
        keys = jax.random.key_data(jax.random.split(jax.random.fold_in(key, 7), batch))
        out["ancestral"] = np.stack([np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.wrap_key_data(k), i), (8, 8, 4), jnp.float32))
            for k in keys]) for i in range(used)])
    return out


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_img2img_matches_jax(pipes, scheduler):
    """Strength 0.6 over 4 steps, 2 prompts: the same first step, the same
    number of UNet calls, images within 1/255 + 1e-6."""
    jpipe, tpipe = pipes
    jpipe.unet_lora = tpipe.unet_lora = None
    seen = {}
    real = jpipe._img2img_fn

    def spy(num_steps, t_start, *rest):
        fn = real(num_steps, t_start, *rest)

        def run(*args):
            seen.update(t_start=t_start, calls=int(args[-1].shape[0]))
            return fn(*args)

        return run

    jpipe._img2img_fn = spy
    kw = dict(strength=STRENGTH, num_inference_steps=STEPS, guidance_scale=7.5, seed=SEED,
              scheduler=scheduler, output_type="np")
    try:
        want = jpipe.img2img(PROMPTS, _init_image(), **kw)
    finally:
        jpipe._img2img_fn = real
    grid = STEPS + 1 if scheduler == "pndm" else STEPS
    t_start = img2img_start(grid, STRENGTH)
    draws = jax_draws(SEED, len(PROMPTS), grid - t_start, scheduler.startswith("euler_a"))
    calls = []
    hook = tpipe.unet.register_forward_hook(lambda *a: calls.append(1))
    try:
        got = tpipe.img2img(PROMPTS, _init_image(), draws=draws, **kw)
    finally:
        hook.remove()
    assert seen == {"t_start": t_start, "calls": len(calls)} and len(calls) == grid - t_start
    assert got.shape == want.shape == (2, 16, 16, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6


@pytest.mark.parametrize("scheduler", ["ddim:karras", "dpm:karras", "foo", "euler:bar"])
def test_img2img_rejects_what_jax_rejects(pipes, scheduler):
    jpipe, tpipe = pipes
    with pytest.raises(ValueError) as want:
        jpipe.img2img("photo", _init_image(), num_inference_steps=2, scheduler=scheduler)
    with pytest.raises(ValueError) as got:
        tpipe.img2img("photo", _init_image(), num_inference_steps=2, scheduler=scheduler)
    assert str(got.value) == str(want.value)


def test_img2img_ancestral_draws(pipes):
    """euler_a draws its per-step noise from the seed after the other two
    (one generator), and refuses given draws without it."""
    _, tpipe = pipes
    d = tpipe.img2img_draws(7, 2, (8, 8), noise_steps=3)
    assert d["ancestral"].shape == (3, 2, 8, 8, 4)
    plain = tpipe.img2img_draws(7, 2, (8, 8))
    assert torch.equal(d["noise"], plain["noise"]) and "ancestral" not in plain
    kw = dict(num_inference_steps=STEPS, strength=STRENGTH, seed=7, output_type="uint8",
              scheduler="euler_a")
    a = tpipe.img2img("photo", _init_image(), **kw)
    b = tpipe.img2img("photo", _init_image(), draws=tpipe.img2img_draws(7, 1, (8, 8), 2), **kw)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="ancestral"):
        tpipe.img2img("photo", _init_image(), draws=tpipe.img2img_draws(7, 1, (8, 8)), **kw)


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_stochastic_ddim_step_matches_jax(prediction):
    """DDIM at eta 0.5 over a 4-step grid (the last step into the terminal
    alpha), JAX's ``jax.random.normal(rng)`` handed to the port."""
    jcfg = jsched.SchedulerConfig(prediction_type=prediction)
    jd = jsched.DDIMScheduler(jcfg)
    td = tsched.DDIMScheduler(tsched.SchedulerConfig(prediction_type=prediction))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    for i, t in enumerate(np.asarray(jd.timesteps(STEPS)).tolist()):
        eps = rng.standard_normal(x.shape).astype(np.float32)
        key = jax.random.PRNGKey(10 + i)
        want = np.asarray(jd.step(jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x), STEPS,
                                  eta=0.5, rng=key))
        noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
        got = td.step(torch.from_numpy(eps), t, torch.from_numpy(x), STEPS, eta=0.5,
                      noise=torch.from_numpy(noise.copy())).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert not np.allclose(got, td.step(torch.from_numpy(eps), t, torch.from_numpy(x),
                                            STEPS).numpy())
        x = np.array(want)
    with pytest.raises(ValueError, match="noise"):
        td.step(torch.from_numpy(eps), t, torch.from_numpy(x), STEPS, eta=0.5)
