"""The port's training slice against the JAX package's, on the CPU.

The UNet LoRA gradients (with and without gradient checkpointing),
``loss_step`` (uint8 pixels, a face mask, prior preservation, cached latent
moments), the latent-moment cache and three steps of ``build_train_step``
(UNet LoRA, UNet + text LoRA, TI with gradient accumulation), at the tiny
configs in fp32.  Both packages get the same weights (the port's through its
weight bridge), the same numpy LoRA trees with non-zero up, and the same
random draws: ``jax.random`` cannot be reproduced in torch, so JAX's draws
for the posterior sample, the noise and the timesteps are computed from the
step's key and handed to the port.

Tolerances: losses 1e-5 relative; gradients 1e-4 relative L2 over the whole
tree (the same fp32 sums in another order through tens of layers);
parameters after a step within 1% of the largest LR (a step moves them by
about lr: AdamW's g / (|g| + eps) turns the gradients' relative noise of
~1e-5 into up to ~1e-3 of the update where a clipped |g| is within a few
orders of eps).
Gradient checkpointing recomputes the same operations in the same order, so
its gradients equal the plain run's to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu import lora as jlora
from diffusion_finetuning_tpu.models import clip_text as jclip
from diffusion_finetuning_tpu.models import schedulers as jsched
from diffusion_finetuning_tpu.models import unet as junet
from diffusion_finetuning_tpu.models import vae as jvae
from diffusion_finetuning_tpu.training import latent_cache as jcache
from diffusion_finetuning_tpu.training import loss as jloss
from diffusion_finetuning_tpu.training import optim as jopt
from diffusion_finetuning_tpu.training import train_step as jtrain

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.models import clip_text as tclip
from diffusion_finetuning_tpu_torch.models import schedulers as tsched
from diffusion_finetuning_tpu_torch.models import unet as tunet
from diffusion_finetuning_tpu_torch.models import vae as tvae
from diffusion_finetuning_tpu_torch.models import weights
from diffusion_finetuning_tpu_torch.training import latent_cache as tcache
from diffusion_finetuning_tpu_torch.training import loss as tloss
from diffusion_finetuning_tpu_torch.training import optim as topt
from diffusion_finetuning_tpu_torch.training import train_step as ttrain

from tests.torch_port_fixtures import numpy_lora_tree, tiny_params, to_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

GRAD_REL_L2 = 1e-4
LATENT = (8, 8, 4)  # the tiny VAE's latent grid for 16x16 pixels


@pytest.fixture(scope="module")
def models():
    """JAX modules + numpy params, and the port's frozen fp32 CPU modules
    holding the same weights."""
    ucfg, vcfg, tcfg = junet.UNetConfig.tiny(), jvae.VAEConfig.tiny(), jclip.CLIPTextConfig.tiny()
    up, vp, cp = tiny_params()
    jax_side = dict(unet=junet.UNet2DConditionModel(ucfg), vae=jvae.AutoencoderKL(vcfg),
                    text_encoder=jclip.CLIPTextModel(tcfg), unet_params=to_jax(up),
                    vae_params=to_jax(vp), text_params=to_jax(cp))
    port = dict(
        unet=weights.load_module(tunet.UNet2DConditionModel, tunet.UNetConfig.tiny(),
                                 weights.unet_state_dict(up, ucfg), torch.float32, "cpu"),
        vae=weights.load_module(tvae.AutoencoderKL, tvae.VAEConfig.tiny(),
                                weights.vae_state_dict(vp, vcfg), torch.float32, "cpu"),
        text_encoder=weights.load_module(tclip.CLIPTextModel, tclip.CLIPTextConfig.tiny(),
                                         weights.text_state_dict(cp, tcfg), torch.float32,
                                         "cpu"))
    unet_targets = jlora.filter_targets(junet.unet_lora_targets(ucfg),
                                        jlora.DEFAULT_TARGET_REPLACE)
    trees = dict(unet=numpy_lora_tree(unet_targets, rank=2, seed=0),
                 text=numpy_lora_tree(jclip.text_encoder_lora_targets(tcfg), rank=2, seed=1))
    return jax_side, port, trees


def _flat(tree):
    """Leaves of a LoRA / params tree (numpy, JAX or torch) in sorted-key
    order, ``scale`` leaves left out -- the order of topt.trainable_tensors."""
    if tree is None:
        return []
    if not isinstance(tree, dict):
        t = tree.detach() if isinstance(tree, torch.Tensor) else tree
        return [np.asarray(t, np.float32).ravel()]
    return [a for k in sorted(tree) if k != "scale" for a in _flat(tree[k])]


def _rel_l2(got, want):
    g, w = np.concatenate(got), np.concatenate(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _grads(tree):
    return [t.grad.numpy().ravel() for t in topt.trainable_tensors(tree)]


def _jax_draws(key, b, t_max):
    """loss_step's draws for ``key``, as the JAX function makes them."""
    r_sample, r_noise, r_t = jax.random.split(key, 3)
    shape = (b,) + LATENT
    return {"sample": np.array(jax.random.normal(r_sample, shape, jnp.float32)),
            "noise": np.array(jax.random.normal(r_noise, shape, jnp.float32)),
            "timesteps": np.array(jax.random.randint(r_t, (b,), 0, t_max))}


@pytest.mark.parametrize("checkpointing", [False, True], ids=["plain", "checkpointed"])
def test_unet_lora_grads_match_jax(models, checkpointing):
    jax_side, port, trees = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([981, 1], np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    cot = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    unet = jax_side["unet"]

    def jfn(lora):
        out = unet.apply({"params": jax_side["unet_params"], "lora": lora}, jnp.asarray(x),
                         jnp.asarray(t), jnp.asarray(ctx))
        return jnp.sum(out * cot)

    want = jax.jit(jax.grad(jfn))(to_jax(trees["unet"]))
    pu = port["unet"]
    pu.config = dataclasses.replace(pu.config, gradient_checkpointing=checkpointing)
    try:
        master = ttrain.master_tree(weights.lora_tree_to_torch(trees["unet"]), "cpu")
        with tlora.attached(pu, master):
            out = pu(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t).long(),
                     torch.from_numpy(ctx))
        # the backward runs after the tree is detached again: a checkpointed
        # recompute must still see the forward's LoRA
        out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    finally:
        pu.config = dataclasses.replace(pu.config, gradient_checkpointing=False)
    assert _rel_l2(_grads(master), _flat(want)) <= GRAD_REL_L2


def test_checkpointing_gives_the_same_grads(models):
    """The checkpointed UNet's LoRA gradients equal the plain run's, and its
    forward runs the LoRA layers twice."""
    _, port, trees = models
    pu = port["unet"]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 8)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 77, 32)).astype(np.float32))
    grads, calls = [], []
    lora_layers = [m for m in pu.modules() if hasattr(m, "lora_up")]
    hooks = [m.register_forward_hook(lambda m, *_: calls.append(m.lora_up is not None))
             for m in lora_layers]
    try:
        for ckpt in (False, True):
            pu.config = dataclasses.replace(pu.config, gradient_checkpointing=ckpt)
            master = ttrain.master_tree(weights.lora_tree_to_torch(trees["unet"]), "cpu")
            calls.clear()
            with tlora.attached(pu, master):
                out = pu(x, torch.tensor([500]), ctx)
            out.square().mean().backward()
            grads.append(_grads(master))
            n_targets = len(list(tlora.lora_leaves(trees["unet"])))
            assert sum(calls) == (2 if ckpt else 1) * n_targets
    finally:
        pu.config = dataclasses.replace(pu.config, gradient_checkpointing=False)
        for h in hooks:
            h.remove()
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


def _batch(variant, b=2, seed=2):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (b, 16, 16, 3), dtype=np.uint8)
    batch = {"pixel_values": px if variant == "uint8" else px.astype(np.float32) / 127.5 - 1.0,
             "input_ids": rng.integers(0, 1000, (b, 77)).astype(np.int32)}
    if variant == "mask":
        batch["mask"] = rng.uniform(0, 1, (b, 16, 16, 1)).astype(np.float32)
    if variant == "prior":  # instance masks only: the class half is padded
        batch["mask"] = rng.uniform(0, 1, (b // 2, 16, 16, 1)).astype(np.float32)
    return batch


@pytest.mark.parametrize("variant", ["uint8", "mask", "prior", "moments"])
def test_loss_step_matches_jax(models, variant):
    """The loss and the UNet + text LoRA gradients with JAX's draws."""
    jax_side, port, trees = models
    batch = _batch(variant)
    kw = dict(t_mutliplier=0.5 if variant == "mask" else 1.0,
              with_prior_preservation=variant == "prior", prior_loss_weight=0.7)
    jbatch = tbatch = batch
    if variant == "moments":
        jbatch = jcache.LatentMomentCache(jax_side["vae"], jax_side["vae_params"]).transform(batch)
        tbatch = tcache.LatentMomentCache(port["vae"], device="cpu").transform(batch)
        np.testing.assert_allclose(tbatch["latent_moments"], jbatch["latent_moments"],
                                   atol=1e-5, rtol=1e-5)
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}

    def jfn(unet_lora, text_lora):
        return jloss.loss_step(
            key, jb, unet=jax_side["unet"], unet_params=jax_side["unet_params"],
            text_encoder=jax_side["text_encoder"], text_params=jax_side["text_params"],
            vae=jax_side["vae"], vae_params=jax_side["vae_params"],
            scheduler=jsched.DDPMScheduler(), unet_lora=unet_lora, text_lora=text_lora, **kw)

    want_loss, (want_u, want_t) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        to_jax(trees["unet"]), to_jax(trees["text"]))

    mu = ttrain.master_tree(weights.lora_tree_to_torch(trees["unet"]), "cpu")
    mt = ttrain.master_tree(weights.lora_tree_to_torch(trees["text"]), "cpu")
    draws = _jax_draws(key, 2, int(1000 * kw["t_mutliplier"]))
    loss = tloss.loss_step(tbatch, unet=port["unet"], text_encoder=port["text_encoder"],
                           vae=port["vae"], scheduler=tsched.DDPMScheduler(), unet_lora=mu,
                           text_lora=mt, draws=draws, **kw)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert _rel_l2(_grads(mu), _flat(want_u)) <= GRAD_REL_L2
    assert _rel_l2(_grads(mt), _flat(want_t)) <= GRAD_REL_L2


def test_loss_step_draws_from_a_generator(models):
    """Without given draws a seeded generator makes the loss reproducible,
    and t_mutliplier bounds the timesteps it draws."""
    _, port, trees = models

    class Spy(tsched.DDPMScheduler):
        def add_noise(self, sample, noise, timesteps):
            self.timesteps = timesteps
            return super().add_noise(sample, noise, timesteps)

    spy = Spy()
    kw = dict(unet=port["unet"], text_encoder=port["text_encoder"], vae=port["vae"],
              scheduler=spy, unet_lora=weights.lora_tree_to_torch(trees["unet"]))
    with torch.no_grad():
        a, b = (float(tloss.loss_step(_batch("uint8"), generator=torch.Generator().manual_seed(9),
                                      **kw)) for _ in range(2))
        c = float(tloss.loss_step(_batch("uint8"), generator=torch.Generator().manual_seed(10),
                                  **kw))
        batch = {k: np.concatenate([v] * 16) for k, v in _batch("uint8").items()}
        tloss.loss_step(batch, generator=torch.Generator().manual_seed(0), t_mutliplier=0.05,
                        **kw)
    assert a == b and a != c
    assert spy.timesteps.shape == (32,) and int(spy.timesteps.max()) < 50


def _configs(emb):
    """(partition, JAX groups, port groups, accum, max_grad_norm, params) per
    train-step case."""
    ti_rows = np.zeros(emb.shape[0], bool)
    ti_rows[[5, 6]] = True
    return {
        "unet_lora": (jtrain.TrainablePartition(unet_lora=True), {"unet_lora": 1e-3}, 1, 0.05,
                      ("unet",), None),
        "text_lora": (jtrain.TrainablePartition(unet_lora=True, text_lora=True),
                      {"unet_lora": 1e-3, "text_lora": 5e-4}, 1, 0.05, ("unet", "text"), None),
        "ti_accum2": (jtrain.TrainablePartition(unet_lora=False, ti=True),
                      {"ti_embeddings": 5e-3}, 2, 1e-3, (), ti_rows),
    }


@pytest.mark.parametrize("case", ["unet_lora", "text_lora", "ti_accum2"])
def test_train_steps_match_jax(models, case):
    """Three steps of build_train_step against JAX's: the loss, the raw
    gradients and the parameters after each step."""
    jax_side, port, trees = models
    emb = np.asarray(jax_side["text_params"]["token_embedding"]["embedding"])
    partition, lrs, accum, max_norm, loras, ti_rows = _configs(emb)[case]
    ti = ti_rows is not None

    jgroups = {k: jopt.ParamGroup(lr=v) for k, v in lrs.items()}
    tgroups = {k: topt.ParamGroup(lr=v) for k, v in lrs.items()}
    jtx = jopt.multi_group_optimizer(jgroups, grad_accum_steps=accum, max_grad_norm=max_norm)
    topt_ = topt.multi_group_optimizer(tgroups, grad_accum_steps=accum, max_grad_norm=max_norm)
    common = dict(grad_accum_steps=accum, clip_ti_decay=True)
    jsched_, tsched_ = jsched.DDPMScheduler(), tsched.DDPMScheduler()
    jstep = jax.jit(jtrain.build_train_step(
        unet=jax_side["unet"], text_encoder=jax_side["text_encoder"], vae=jax_side["vae"],
        scheduler=jsched_, optimizer=jtx, partition=partition,
        ti_lr_schedule=jopt.lr_schedule("constant", 5e-3) if ti else None, **common))
    tstep = ttrain.build_train_step(
        unet=port["unet"], text_encoder=port["text_encoder"], vae=port["vae"],
        scheduler=tsched_, optimizer=topt_,
        partition=ttrain.TrainablePartition(**dataclasses.asdict(partition)),
        ti_lr_schedule=topt.lr_schedule("constant", 5e-3) if ti else None, **common)

    jparams = {f"{n}_lora": to_jax(trees[n]) for n in loras}
    if ti:
        jparams["ti_embeddings"] = jnp.asarray(emb)
    jstate = {"params": jparams,
              "static": {"unet_params": jax_side["unet_params"],
                         "text_params": jax_side["text_params"],
                         "vae_params": jax_side["vae_params"], "orig_embeddings": jnp.asarray(emb),
                         "index_updates": jnp.asarray(ti_rows if ti else np.zeros(len(emb), bool))},
              "opt_state": jtx.init(jparams), "step": jnp.zeros((), jnp.int32)}
    tstate = ttrain.init_train_state(
        topt_, **{f"{n}_lora": weights.lora_tree_to_torch(trees[n]) for n in loras},
        ti_embeddings=emb if ti else None, index_updates=ti_rows, device="cpu")

    def jloss_fn(params, batch, key):
        text_params = jax_side["text_params"]
        if ti:
            text_params = {**text_params, "token_embedding": {"embedding": params["ti_embeddings"]}}
        return jloss.loss_step(
            key, batch, unet=jax_side["unet"], unet_params=jax_side["unet_params"],
            text_encoder=jax_side["text_encoder"], text_params=text_params, vae=jax_side["vae"],
            vae_params=jax_side["vae_params"], scheduler=jsched_,
            unet_lora=params.get("unet_lora"), text_lora=params.get("text_lora"))

    jgrad = jax.jit(jax.grad(jloss_fn))
    seen = []
    step_fn = topt_.step
    topt_.step = lambda st: (seen.append([p.grad.clone().numpy().ravel() for p in st.params()]),
                             step_fn(st))[1]
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    for i, key in enumerate(keys):
        batch = _batch("uint8", b=1, seed=10 + i)
        batch["input_ids"][0, :3] = [5, 6, 7]
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want_g = jgrad(jstate["params"], jb, key)
        if ti:  # frozen rows get no gradient, as in the JAX step
            want_g = {**want_g, "ti_embeddings": jnp.where(
                jnp.asarray(ti_rows)[:, None], want_g["ti_embeddings"], 0.0)}
        jstate, jm = jstep(jstate, jb, key)
        tstate, tm = tstep(tstate, batch, draws=_jax_draws(key, 1, 1000))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert _rel_l2(seen[-1], _flat(want_g)) <= GRAD_REL_L2
        assert np.linalg.norm(np.concatenate(seen[-1])) > max_norm  # clipping is active
        for got, want in zip(_flat(tstate["params"]), _flat(jstate["params"])):
            np.testing.assert_allclose(got, want, atol=1e-2 * max(lrs.values()), rtol=0)
    assert tstate["step"] == int(jstate["step"]) == 3
    # the scale leaves never move; the trained leaves do
    for n in loras:
        for path, leaf in tlora.lora_leaves(tstate["params"][f"{n}_lora"]):
            assert float(leaf["scale"]) == pytest.approx(0.7)
    moved = _rel_l2(_flat(tstate["params"]), _flat(
        {f"{n}_lora": trees[n] for n in loras} | ({"ti_embeddings": emb} if ti else {})))
    assert moved > 1e-6
