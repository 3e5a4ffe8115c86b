"""The port's models against the JAX package's at the tiny configs, on the CPU.

The JAX models are initialised from a seed; their parameter trees go through
the port's weight bridge (models/weights.py) into the port's modules with
strict loading.  LoRA trees with non-zero up are made with numpy and handed
to both packages.  Everything is fp32; tolerance 1e-4 for whole models (the
same sums in another order through tens of layers), 1e-5 for the scheduler.
"""

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

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.models import clip_text as tclip
from diffusion_finetuning_tpu_torch.models import schedulers as tsched
from diffusion_finetuning_tpu_torch.models import unet as tunet
from diffusion_finetuning_tpu_torch.models import vae as tvae
from diffusion_finetuning_tpu_torch.models import weights

from tests.jitutil import jit_apply
from tests.torch_port_fixtures import numpy_lora_tree, tiny_params, to_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-4


def _load(module, sd):
    module.load_state_dict(weights.to_torch(sd, torch.float32), strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def unet_pair():
    cfg = junet.UNetConfig.tiny()
    params = tiny_params()[0]
    port = _load(tunet.UNet2DConditionModel(tunet.UNetConfig.tiny()),
                 weights.unet_state_dict(params, cfg))
    return cfg, params, port


def _unet_inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    t = np.array([981, 1][:b], np.int32)
    ctx = rng.standard_normal((b, 77, 32)).astype(np.float32)
    return x, t, ctx


def _run_unet_pair(unet_pair, lora_np):
    cfg, params, port = unet_pair
    x, t, ctx = _unet_inputs()
    variables = {"params": to_jax(params)}
    if lora_np is not None:
        variables["lora"] = to_jax(lora_np)
    want = jit_apply(junet.UNet2DConditionModel(cfg))(
        variables, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    tree = None if lora_np is None else weights.lora_tree_to_torch(lora_np)
    with torch.no_grad(), tlora.attached(port, tree):
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t).long(),
                   torch.from_numpy(ctx))
    # the layers drop the tree again on exit
    assert all(m.lora_up is None for m in port.modules() if hasattr(m, "lora_up"))
    return got.permute(0, 2, 3, 1).numpy(), np.asarray(want)


@pytest.mark.parametrize("which", ["unet", "vae", "text"])
def test_weight_bridge_loads_strict(which):
    """Every key of the JAX tree maps onto exactly the port's module keys,
    with the port's shapes (strict load; no missing or extra key)."""
    unet_p, vae_p, text_p = tiny_params()
    if which == "unet":
        sd, mod = (weights.unet_state_dict(unet_p, junet.UNetConfig.tiny()),
                   tunet.UNet2DConditionModel(tunet.UNetConfig.tiny()))
    elif which == "vae":
        sd, mod = (weights.vae_state_dict(vae_p, jvae.VAEConfig.tiny()),
                   tvae.AutoencoderKL(tvae.VAEConfig.tiny()))
    else:
        sd, mod = (weights.text_state_dict(text_p, jclip.CLIPTextConfig.tiny()),
                   tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny()))
    assert set(sd) == set(mod.state_dict())
    _load(mod, sd)
    for k, v in mod.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_unet_matches_jax(unet_pair):
    got, want = _run_unet_pair(unet_pair, None)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("targets", ["default", "extended"])
def test_unet_with_lora_matches_jax(unet_pair, targets):
    """Non-zero LoRA on the default targets (dense, through lora_dense) and
    on the extended set (the resnet convs too, through LoRAConv2d)."""
    cfg = unet_pair[0]
    replace = (jlora.DEFAULT_TARGET_REPLACE if targets == "default"
               else jlora.UNET_EXTENDED_TARGET_REPLACE)
    tgts = jlora.filter_targets(junet.unet_all_lora_targets(cfg), replace)
    got, want = _run_unet_pair(unet_pair, numpy_lora_tree(tgts))
    base, _ = _run_unet_pair(unet_pair, None)
    assert np.abs(got - base).max() > 1e-2  # the LoRA moves the output
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("name", ["tiny", "sd15", "sd21"])
def test_unet_lora_targets_match_jax_order(name):
    jt = junet.unet_all_lora_targets(getattr(junet.UNetConfig, name)())
    tt = tunet.unet_all_lora_targets(getattr(tunet.UNetConfig, name)())
    assert [(t.path, t.in_features, t.out_features, t.ancestor, t.kernel_size)
            for t in jt] == [(t.path, t.in_features, t.out_features, t.ancestor,
                              t.kernel_size) for t in tt]
    for replace in (jlora.DEFAULT_TARGET_REPLACE, jlora.UNET_EXTENDED_TARGET_REPLACE):
        assert ([t.path for t in jlora.filter_targets(jt, replace)]
                == [t.path for t in tlora.filter_targets(tt, replace)])


def test_lora_targets_name_port_modules_with_matching_shapes():
    """Each target's JAX path maps to a port module of the target's shape."""
    cfg = tunet.UNetConfig.sd15()
    with torch.device("meta"):
        unet = tunet.UNet2DConditionModel(cfg)
        clip = tclip.CLIPTextModel(tclip.CLIPTextConfig.sd15())
    assert (tlora.module_name(("down_blocks_0_attentions_0", "transformer_blocks_0",
                               "attn1", "to_q"))
            == "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q")
    for model, targets in ((unet, tunet.unet_all_lora_targets(cfg)),
                           (clip, tclip.text_encoder_lora_targets(clip.config))):
        for t in targets:
            w = model.get_submodule(tlora.module_name(t.path, model.lora_prefix)).weight
            assert (w.shape[0], w.shape[1]) == (t.out_features, t.in_features)
            if t.is_conv:
                assert tuple(w.shape[2:]) == t.kernel_size


def test_text_lora_targets_match_jax_order():
    jt = jclip.text_encoder_lora_targets(jclip.CLIPTextConfig.sd15())
    tt = tclip.text_encoder_lora_targets(tclip.CLIPTextConfig.sd15())
    assert [(t.path, t.in_features, t.ancestor) for t in jt] == [
        (t.path, t.in_features, t.ancestor) for t in tt]


def test_materialize_matches_jax(unet_pair):
    cfg, params, port = unet_pair
    tgts = jlora.filter_targets(junet.unet_all_lora_targets(cfg),
                                jlora.UNET_EXTENDED_TARGET_REPLACE)
    lora_np = numpy_lora_tree(tgts, seed=5)
    merged_j = weights.unet_state_dict(
        jax.tree_util.tree_map(np.asarray, jlora.materialize_lora_tree(
            to_jax(params), to_jax(lora_np))), cfg)
    merged_t = tlora.materialize_lora_tree(port, weights.lora_tree_to_torch(lora_np))
    assert len(merged_t) == len(tgts)
    base = port.state_dict()
    for k, v in merged_j.items():
        got = merged_t[k] if k in merged_t else base[k]
        np.testing.assert_allclose(got.numpy(), v, atol=1e-6, rtol=1e-6)


def test_inject_and_tune_lora_scale():
    tgts = tunet.unet_lora_targets(tunet.UNetConfig.tiny())
    tree = tlora.inject_trainable_lora(tgts, torch.Generator().manual_seed(0), r=2)
    leaves = dict(tlora.lora_leaves(tree))
    assert [t.path for t in tgts] == list(leaves)
    for t in tgts:
        leaf = leaves[t.path]
        assert leaf["up"].shape == (t.out_features, 2) and not leaf["up"].any()
        assert leaf["down"].shape == (2, t.in_features) and leaf["down"].std() > 0.1
    tuned = tlora.tune_lora_scale(tree, 0.25)
    assert all(float(l["scale"]) == 0.25 for _, l in tlora.lora_leaves(tuned))
    assert all(float(l["scale"]) == 1.0 for _, l in tlora.lora_leaves(tree))


def test_inject_lora_leaves_follow_the_generator_device():
    """Without a ``device`` the tree lies where the generator draws (the
    port's entry points take no CPU default); the same draws as naming that
    device."""
    tgts = tunet.unet_lora_targets(tunet.UNetConfig.tiny())[:3]
    gen = torch.Generator().manual_seed(1)
    tree = tlora.inject_trainable_lora(tgts, gen, r=2)
    named = tlora.inject_trainable_lora(tgts, torch.Generator().manual_seed(1), r=2,
                                        device=gen.device)
    for (_, leaf), (_, ref) in zip(tlora.lora_leaves(tree), tlora.lora_leaves(named)):
        assert all(t.device == gen.device for t in leaf.values())
        assert all(torch.equal(leaf[k], ref[k]) for k in ("up", "down", "scale"))


def test_clip_matches_jax():
    from diffusion_finetuning_tpu.data.tokenizer import CLIPTokenizer

    cfg = jclip.CLIPTextConfig.tiny()
    params = tiny_params()[2]
    ids = CLIPTokenizer.tiny(["photo", "of", "sks"])(
        ["a photo of sks", ""], padding="max_length", max_length=77,
        return_tensors="np")["input_ids"]
    tgts = jclip.text_encoder_lora_targets(cfg)
    lora_np = numpy_lora_tree(tgts, seed=7)
    want = jit_apply(jclip.CLIPTextModel(cfg))(
        {"params": to_jax(params), "lora": to_jax(lora_np)}, jnp.asarray(ids))
    port = _load(tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny()),
                 weights.text_state_dict(params, cfg))
    with torch.no_grad(), tlora.attached(port, weights.lora_tree_to_torch(lora_np)):
        got = port(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.fixture(scope="module")
def vae_pair():
    cfg = jvae.VAEConfig.tiny()
    params = tiny_params()[1]
    port = _load(tvae.AutoencoderKL(tvae.VAEConfig.tiny()),
                 weights.vae_state_dict(params, cfg))
    return cfg, params, port


def test_vae_decode_matches_jax(vae_pair):
    cfg, params, port = vae_pair
    z = np.random.default_rng(8).standard_normal((2, 8, 8, 4)).astype(np.float32)
    mod = jvae.AutoencoderKL(cfg)
    want = mod.apply({"params": to_jax(params)}, jnp.asarray(z), method=mod.decode)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_vae_encode_mode_matches_jax(vae_pair):
    """Encoder with its asymmetric downsample pad; posterior mode and std."""
    cfg, params, port = vae_pair
    x = np.random.default_rng(9).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    mod = jvae.AutoencoderKL(cfg)
    post = mod.apply({"params": to_jax(params)}, jnp.asarray(x), method=mod.encode)
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in ((got.mode(), post.mode()), (got.std, post.std)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("steps", [50, 7])
def test_ddim_matches_jax(prediction_type, steps):
    jcfg = jsched.SchedulerConfig(prediction_type=prediction_type)
    tcfg = tsched.SchedulerConfig(prediction_type=prediction_type)
    js, ts = jsched.DDIMScheduler(jcfg), tsched.DDIMScheduler(tcfg)
    np.testing.assert_array_equal(ts.timesteps(steps).numpy(),
                                  np.asarray(js.timesteps(steps)))
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    for t in ts.timesteps(steps).tolist():
        eps = rng.standard_normal(x.shape).astype(np.float32)
        want = np.asarray(js.step(jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x), steps))
        got = ts.step(torch.from_numpy(eps), t, torch.from_numpy(x), steps).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        x = want
