"""The port's txt2img samplers against the JAX package's, on the CPU.

Grids (timesteps, sigmas plain and Karras, ``init_noise_sigma``, the LMS
coefficient table) come from the same numpy code on both sides and must be
equal.  Each sampler's steps on fixed inputs (a sample and one model output
a step, Euler-ancestral given JAX's per-step noise) agree within 1e-5
relative to the sample's scale: both compute in fp32, the coefficients on
the host here and in XLA there, so single values may differ in the last
bits and those differences carry through the steps.  The whole txt2img
request per new sampler (given latents, CFG, 3 steps) agrees with the JAX
pipeline's uint8 images within 1/255, as the DDIM request does
(``test_torch_port_pipeline.py``).  To keep the JAX compiles few, the
request runs for PNDM, DPM++, Euler-ancestral (JAX's noise handed in) and
LMS on the Karras grid; every variant's steps are held above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
from diffusion_finetuning_tpu.models import schedulers as js
from diffusion_finetuning_tpu.models.clip_text import CLIPTextConfig as JClip
from diffusion_finetuning_tpu.models.unet import UNetConfig as JUNet
from diffusion_finetuning_tpu.models.vae import VAEConfig as JVAE
from diffusion_finetuning_tpu.pipelines.pipeline import StableDiffusionPipeline as JaxPipe

from diffusion_finetuning_tpu_torch.models import schedulers as ts
from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline

from tests.test_torch_port_pipeline import PROMPTS, WORDS, _port_pipe
from tests.torch_port_fixtures import tiny_params, to_jax

VARIANTS = ["pndm", "dpm", "euler", "euler:karras", "euler_a", "euler_a:karras", "lms",
            "lms:karras"]
JAX_CLASSES = {"pndm": js.PNDMScheduler, "dpm": js.DPMSolverMultistepScheduler,
               "euler": js.EulerDiscreteScheduler, "euler_a": js.EulerAncestralDiscreteScheduler,
               "lms": js.LMSDiscreteScheduler}


def _pair(name, cfg=ts.SchedulerConfig()):
    base, _, variant = name.partition(":")
    kw = {"karras": True} if variant else {}
    jcfg = js.SchedulerConfig(**vars(cfg))
    if base in ("euler", "euler_a", "lms"):
        kw.setdefault("karras", False)
    return JAX_CLASSES[base](jcfg, **kw), ts.txt2img_scheduler(name, cfg)


def _ancestral_noise(keys, steps, shape):
    """JAX's Euler-ancestral draws: step i of sample b from
    ``fold_in(key_b, i)`` (models/schedulers.py:419-424), (steps, B, ...)."""
    return np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.wrap_key_data(k), i), shape, jnp.float32))
        for k in keys]) for i in range(steps)])


@pytest.mark.parametrize("name", VARIANTS)
def test_grids_match_jax(name):
    jsch, tsch = _pair(name)
    for n in (4, 25, 50):
        np.testing.assert_array_equal(tsch.timesteps(n).numpy(), np.asarray(jsch.timesteps(n)))
        if hasattr(jsch, "_sigmas_np"):
            np.testing.assert_array_equal(tsch._sigmas_np(n), jsch._sigmas_np(n))
            assert tsch.init_noise_sigma(n) == jsch.init_noise_sigma(n)
        if hasattr(jsch, "_lms_coeffs_np"):
            np.testing.assert_array_equal(tsch._lms_coeffs_np(n), jsch._lms_coeffs_np(n))
        if hasattr(jsch, "_prev_timesteps_np"):
            np.testing.assert_array_equal(tsch._prev_timesteps_np(n),
                                          jsch._prev_timesteps_np(n))


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("name", VARIANTS)
def test_steps_match_jax(name, prediction):
    """n = 6 steps (PNDM: its 7 timesteps) from one sample with one model
    output a step, through each package's step function."""
    cfg = ts.SchedulerConfig(prediction_type=prediction)
    jsch, tsch = _pair(name, cfg)
    n, shape = 6, (2, 4, 4, 4)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    grid = np.asarray(jsch.timesteps(n))
    outs = rng.standard_normal((len(grid),) + shape).astype(np.float32)
    sigma_space = hasattr(jsch, "_sigmas_np")
    if sigma_space:
        x = x * jsch.init_noise_sigma(n)
        keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(3), shape[0]))
        jstate = jsch.init_state(shape, jnp.float32, rng=keys)
        noise = _ancestral_noise(keys, n, shape[1:])
        tstate = tsch.init_state(torch.from_numpy(x), n, noise=torch.from_numpy(noise))
    else:
        jstate = jsch.init_state(shape, jnp.float32)
        tstate = tsch.init_state(torch.from_numpy(x), n)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i, t in enumerate(grid):
        if sigma_space:
            np.testing.assert_allclose(tsch.scale_model_input(tx, tstate, n).numpy(),
                                       np.asarray(jsch.scale_model_input(jx, jstate, n)),
                                       rtol=1e-5, atol=1e-5)
        jx, jstate = jsch.step(jnp.asarray(outs[i]), t, jx, jstate, n)
        tx, tstate = tsch.step(torch.from_numpy(outs[i]), t.item(), tx, tstate, n)
        scale = float(np.abs(np.asarray(jx)).max())
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5 * scale)
    assert tstate["counter"] == len(grid)


def test_scheduler_names_are_checked():
    with pytest.raises(ValueError, match="karras"):
        ts.txt2img_scheduler("dpm:karras", ts.SchedulerConfig())
    with pytest.raises(ValueError, match="variant"):
        ts.txt2img_scheduler("euler:fast", ts.SchedulerConfig())
    with pytest.raises(ValueError, match="unknown scheduler"):
        ts.txt2img_scheduler("heun", ts.SchedulerConfig())
    with pytest.raises(ValueError, match="noise"):
        ts.txt2img_scheduler("euler_a", ts.SchedulerConfig()).init_state(torch.zeros(1), 2)
    assert isinstance(ts.txt2img_scheduler("ddim", ts.SchedulerConfig()), ts.DDIMScheduler)


@pytest.fixture(scope="module")
def pipes():
    unet_p, vae_p, text_p = tiny_params()
    jpipe = JaxPipe(JUNet.tiny(), to_jax(unet_p), JVAE.tiny(), to_jax(vae_p),
                    JClip.tiny(), to_jax(text_p), JaxTokenizer.tiny(WORDS), js.SchedulerConfig())
    return jpipe, _port_pipe()


@pytest.mark.parametrize("scheduler", ["pndm", "dpm", "euler_a", "lms:karras"])
def test_txt2img_per_sampler_matches_jax(pipes, scheduler):
    """3 steps, CFG 7.5, given latents; Euler-ancestral gets the noise JAX
    draws for given latents (keys split from PRNGKey(1), pipeline.py:672)."""
    jpipe, tpipe = pipes
    jpipe.unet_lora = tpipe.unet_lora = None
    steps = 3
    lat = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
    kw = dict(height=16, width=16, num_inference_steps=steps, guidance_scale=7.5,
              scheduler=scheduler, output_type="np")
    want = jpipe(PROMPTS, latents=jnp.asarray(lat), **kw)
    noise = None
    if scheduler == "euler_a":
        keys = jax.random.key_data(jax.random.split(jax.random.PRNGKey(1), 2))
        noise = _ancestral_noise(keys, steps, (8, 8, 4))
    got = tpipe(PROMPTS, latents=lat, noise=noise, **kw)
    assert got.shape == want.shape == (2, 16, 16, 3)
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
    assert got.std() > 0.01


def test_ancestral_noise_is_per_seed():
    """Seeded Euler-ancestral requests: a seed's latents and noise do not
    depend on its batch position (drawn per seed, the noise after the
    latents), so neither does its image, up to one uint8 level (batch 2 and
    batch 1 run the CPU's matmuls in another order)."""
    pipe = _port_pipe()
    pair_lat, pair_noise = pipe._initial_latents(2, 16, 16, None, [5, 6], noise_steps=3)
    lat, noise = pipe._initial_latents(1, 16, 16, None, [6], noise_steps=3)
    assert pair_noise.shape == (3, 2, 4, 8, 8)
    assert torch.equal(pair_lat[1:], lat) and torch.equal(pair_noise[:, 1:], noise)
    kw = dict(height=16, width=16, num_inference_steps=3, scheduler="euler_a",
              output_type="uint8")
    pair = pipe(["photo", "photo"], seed=[5, 6], **kw)
    alone = pipe("photo", seed=6, **kw)
    assert np.abs(pair[1].astype(int) - alone[0].astype(int)).max() <= 1
    assert np.abs(pair[0].astype(int) - pair[1].astype(int)).max() > 1
    with pytest.raises(ValueError, match="noise"):
        pipe("photo", noise=np.zeros((2, 1, 8, 8, 4), np.float32), **kw)
    assert isinstance(pipe, StableDiffusionPipeline)
