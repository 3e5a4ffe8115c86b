"""The port's fused dispatch (``multi_step``, ``FusedDispatcher``) against
the JAX package's, on the CPU, at the tiny configs in fp32.

On the CPU the port's graphs do not exist and the same functions run the
steps eagerly; what is held against JAX here is their contract: k fused
steps equal k sequential steps, ``carry_dtype`` rounds the carried state as
JAX's hoisted scan does, and the dispatcher groups, clips and counts steps
as JAX's does.  JAX's draws are computed from the keys its wrappers split
and handed to the port (``jax.random`` cannot be reproduced in torch).

Tolerances, as ``test_torch_port_training.py``: losses 1e-5 relative;
parameters within 1% of the LR for each step taken (AdamW's g / (|g| +
eps) turns the gradients' relative differences of ~1e-5 into up to ~1e-3 of
an update where a clipped |g| is within a few orders of eps, and the steps
add them up).  With ``carry_dtype=bfloat16`` the
parameters after the steps must be bf16 values, within one bf16 step (2^-8
of the value) plus that of JAX's: gradients that agree to 1e-5 can round to
neighbouring bf16 values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu.models import schedulers as jsched
from diffusion_finetuning_tpu.training import optim as jopt
from diffusion_finetuning_tpu.training import train_step as jtrain

from diffusion_finetuning_tpu_torch.models import schedulers as tsched
from diffusion_finetuning_tpu_torch.models import weights
from diffusion_finetuning_tpu_torch.training import optim as topt
from diffusion_finetuning_tpu_torch.training import train_step as ttrain

from tests.torch_port_fixtures import to_jax, training_models

LR = 1e-3
LATENT = (8, 8, 4)  # the tiny VAE's latent grid for 16x16 pixels


@pytest.fixture(scope="module")
def setup():
    """Both packages' step functions (UNet LoRA, clip 0.05) and a maker of
    fresh equal states."""
    jax_side, port, trees = training_models()
    jtx = jopt.multi_group_optimizer({"unet_lora": jopt.ParamGroup(lr=LR)}, max_grad_norm=0.05)
    ttx = topt.multi_group_optimizer({"unet_lora": topt.ParamGroup(lr=LR)}, max_grad_norm=0.05)
    jstep = jtrain.build_train_step(
        unet=jax_side["unet"], text_encoder=jax_side["text_encoder"], vae=jax_side["vae"],
        scheduler=jsched.DDPMScheduler(), optimizer=jtx,
        partition=jtrain.TrainablePartition(unet_lora=True))
    tstep = ttrain.build_train_step(
        unet=port["unet"], text_encoder=port["text_encoder"], vae=port["vae"],
        scheduler=tsched.DDPMScheduler(), optimizer=ttx,
        partition=ttrain.TrainablePartition(unet_lora=True))

    def states():
        jparams = {"unet_lora": to_jax(trees["unet"])}
        jstate = {"params": jparams,
                  "static": {"unet_params": jax_side["unet_params"],
                             "text_params": jax_side["text_params"],
                             "vae_params": jax_side["vae_params"]},
                  "opt_state": jtx.init(jparams), "step": jnp.zeros((), jnp.int32)}
        tstate = ttrain.init_train_state(
            ttx, unet_lora=weights.lora_tree_to_torch(trees["unet"]), device="cpu")
        return jstate, tstate

    return jstep, tstep, states


def _batch(i):
    rng = np.random.default_rng(20 + i)
    return {"pixel_values": rng.integers(0, 256, (1, 16, 16, 3), dtype=np.uint8),
            "input_ids": rng.integers(0, 1000, (1, 77)).astype(np.int32)}


def _jax_draws(key):
    """loss_step's draws for ``key`` (batch 1), as the JAX function makes them."""
    r_sample, r_noise, r_t = jax.random.split(key, 3)
    shape = (1,) + LATENT
    return {"sample": np.array(jax.random.normal(r_sample, shape, jnp.float32)),
            "noise": np.array(jax.random.normal(r_noise, shape, jnp.float32)),
            "timesteps": np.array(jax.random.randint(r_t, (1,), 0, 1000))}


def _flat(tree):
    if tree is None:
        return []
    if not isinstance(tree, dict):
        t = tree.detach() if isinstance(tree, torch.Tensor) else tree
        return [np.asarray(t, np.float32).ravel()]
    return [a for k in sorted(tree) if k != "scale" for a in _flat(tree[k])]


def _check_params(tstate, jstate, bf16_step=0.0):
    for got, want in zip(_flat(tstate["params"]), _flat(jstate["params"])):
        np.testing.assert_allclose(got, want, rtol=bf16_step,
                                   atol=1e-2 * LR * tstate["step"])


def test_multi_step_equals_sequential_jax_steps(setup):
    """multi_step(step, 3) against 3 sequential JAX steps with the keys
    JAX's multi_step splits: the (3,) losses and the parameters."""
    jstep, tstep, states = setup
    jstate, tstate = states()
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    batches = [_batch(i) for i in range(3)]
    jitted = jax.jit(jstep)
    want = []
    for batch, key in zip(batches, keys):
        jstate, m = jitted(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        want.append(float(m["loss"]))
    fused = ttrain.multi_step(tstep, 3)
    assert ttrain.multi_step(tstep, 3) is fused  # memoised per (step_fn, k, carry_dtype)
    tstate, m = fused(tstate, ttrain.stack_batches(batches),
                      draws=ttrain.stack_batches([_jax_draws(k) for k in keys]))
    assert m["loss"].shape == (3,)
    np.testing.assert_allclose(m["loss"].numpy(), want, rtol=1e-5)
    assert tstate["step"] == int(jstate["step"]) == 3 and int(tstate["device_step"]) == 3
    assert int(tstate["opt_state"].count) == 3
    _check_params(tstate, jstate)


def test_multi_step_carry_dtype_matches_jax(setup):
    """multi_step(step, 3, carry_dtype=bfloat16) against JAX's hoisted scan
    (a state with ``static``): the carried fp32 state is rounded to bf16
    before each step and after the last."""
    jstep, tstep, states = setup
    jstate, tstate = states()
    rng = jax.random.PRNGKey(9)
    batches = [_batch(10 + i) for i in range(3)]
    jfused = jax.jit(jtrain.multi_step(jstep, 3, carry_dtype=jnp.bfloat16))
    jstate, jm = jfused(jstate, {k: jnp.asarray(v) for k, v in
                                 jtrain.stack_batches(batches).items()}, rng)
    draws = [_jax_draws(k) for k in jax.random.split(rng, 3)]
    tstate, tm = ttrain.multi_step(tstep, 3, carry_dtype=torch.bfloat16)(
        tstate, ttrain.stack_batches(batches), draws=ttrain.stack_batches(draws))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5)
    for t in ttrain.carried_tensors(tstate):
        if t.dtype == torch.float32:  # stored at bf16 between and after the steps
            assert torch.equal(t, t.bfloat16().float())
    m = tstate["opt_state"].moments["unet_lora"]["m"]
    assert float(m.abs().max()) > 0
    _check_params(tstate, jstate, bf16_step=2.0 ** -8)


def test_fused_dispatcher_drive_matches_jax(setup, capsys):
    """FusedDispatcher(spd=3).drive over 7 steps with groups clipped at a
    window of 5 -- sizes 3, 2, 2: a full group through the fused graph, a
    one-off size 2 through the per-step path, the same size again through a
    fused graph of its own -- against JAX's dispatcher: the losses, the
    steps yielded and the parameters."""
    jstep, tstep, states = setup
    jstate, tstate = states()
    batches = [_batch(30 + i) for i in range(7)]

    def take(gs, wrap=lambda b: b):
        end = min(gs + 3, 5 if gs < 5 else 7)
        return [wrap(b) for b in batches[gs:end]]

    rng = jax.random.PRNGKey(11)
    jd = jtrain.FusedDispatcher(jstep, spd=3)
    want, key_of = [], {}
    for jstate, losses, stepped, gs in jd.drive(
            jstate, rng, lambda gs: take(gs, lambda b: {k: jnp.asarray(v) for k, v in b.items()}),
            7):
        want.append((np.asarray(losses), stepped, gs))
    # the keys JAX's drive gave each step: split per dispatch, then per step
    gs = 0
    for n in (3, 2, 2):
        rng, key = jax.random.split(rng)
        for i, k in enumerate(jax.random.split(key, n)):
            key_of[gs + i] = k
        gs += n
    capsys.readouterr()
    td = ttrain.FusedDispatcher(tstep, spd=3)
    got = [(losses.numpy(), stepped, gs) for tstate, losses, stepped, gs in td.drive(
        tstate, None, take, 7, draws=lambda s: _jax_draws(key_of[s]))]
    assert "recurring group size 2" in capsys.readouterr().out
    assert [g[1:] for g in got] == [w[1:] for w in want] == [(3, 3), (2, 5), (2, 7)]
    for (gl, *_), (wl, *_) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
    assert sorted(td._fused) == [2, 3] and td._tail is not None
    assert tstate["step"] == int(jstate["step"]) == 7
    _check_params(tstate, jstate)


def test_dispatcher_and_jit_reject_a_mesh(setup):
    """A mesh must be the port's ``parallel.mesh.Mesh`` (a JAX mesh, say, is
    refused); the port's own meshes run in tests/test_torch_port_parallel.py."""
    _, tstep, _ = setup
    with pytest.raises(TypeError, match="parallel.mesh"):
        ttrain.FusedDispatcher(tstep, spd=2, mesh=object())
    with pytest.raises(TypeError, match="parallel.mesh"):
        ttrain.jit_train_step(tstep, mesh=object())


def test_jit_train_step_runs_the_step_eagerly_on_the_cpu(setup):
    """On the CPU jit_train_step is the eager step: the same loss and
    parameters as a direct call from an equal state with the same
    generator; aot_compile steps nothing."""
    _, tstep, states = setup
    _, a = states()
    _, b = states()
    jitted = ttrain.jit_train_step(tstep)
    assert ttrain.jit_train_step(tstep) is jitted
    assert jitted.aot_compile(a, _batch(0)) is jitted and a["step"] == 0
    a, ma = jitted(a, _batch(0), torch.Generator().manual_seed(3))
    b, mb = tstep(b, _batch(0), torch.Generator().manual_seed(3))
    assert torch.equal(ma["loss"], mb["loss"]) and a["step"] == b["step"] == 1
    for x, y in zip(ttrain.carried_tensors(a), ttrain.carried_tensors(b)):
        assert torch.equal(x, y)


def test_step_draws_are_the_generators_draws(setup):
    """step.draws(batch, generator) makes the draws a step with that
    generator makes: handed in, they give the same loss bit for bit."""
    _, tstep, states = setup
    _, a = states()
    _, b = states()
    d = tstep.draws(_batch(1), torch.Generator().manual_seed(5))
    assert d["sample"].shape == (1,) + LATENT and d["timesteps"].dtype == torch.int64
    _, ma = tstep(a, _batch(1), draws=d)
    _, mb = tstep(b, _batch(1), torch.Generator().manual_seed(5))
    assert torch.equal(ma["loss"], mb["loss"])
    assert dataclasses.is_dataclass(a["opt_state"])
