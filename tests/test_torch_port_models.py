"""The port's models against the JAX package's at the tiny configs, on the CPU.

The JAX models are initialised from a seed; their parameter trees go through
the port's weight bridge (models/weights.py) into the port's modules with
strict loading.  LoRA trees with non-zero up are made with numpy and handed
to both packages.  Everything is fp32; tolerance 1e-4 for whole models (the
same sums in another order through tens of layers), 1e-5 for the scheduler.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

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


# -- the channels-last path (ops/channels_last.py) against the NCHW one --------

from diffusion_finetuning_tpu_torch.models import layers as tlayers  # noqa: E402
from diffusion_finetuning_tpu_torch.ops import channels_last as tcl  # noqa: E402

CL = torch.channels_last
# fp32 tolerance of a whole channels-last model against the same model on
# NCHW: the same operations, whose convolutions sum in another order
CL_ATOL = 1e-4


def _nhwc_calls(fn, scope=True):
    """(fn() inside the channels-last scope or outside it, channels-last
    calls it made, fallbacks it made)."""
    calls, falls = tcl.calls, tcl.fallbacks
    with tcl.scope(scope):
        out = fn()
    return out, tcl.calls - calls, tcl.fallbacks - falls


def _sd21_style_unet():
    torch.manual_seed(3)
    cfg = dataclasses.replace(tunet.UNetConfig.tiny(), use_linear_projection=True)
    return tunet.UNet2DConditionModel(cfg).eval()


@pytest.mark.parametrize("proj", ["conv", "linear"], ids=["sd15_conv_proj", "sd21_linear_proj"])
def test_unet_channels_last_matches_nchw(unet_pair, proj):
    """The tiny UNet (SD 1.5's conv proj_in/proj_out, or SD 2.1's linear
    ones) on a channels-last 16^2 input inside the channels-last scope
    against the same module on NCHW: within CL_ATOL, the output NCHW-shaped
    and channels-last, every conv and GroupNorm called once on the
    channels-last path, none refused."""
    model = unet_pair[2] if proj == "conv" else _sd21_style_unet()
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 32)).astype(np.float32))
    t = torch.tensor([981, 1])
    with torch.no_grad():
        want, calls, _ = _nhwc_calls(lambda: model(x, t, ctx), scope=False)
        assert calls == 0
        got, calls, falls = _nhwc_calls(lambda: model(x.contiguous(memory_format=CL), t, ctx))
    convs = sum(isinstance(m, nn.Conv2d) for m in model.modules())
    norms = sum(isinstance(m, tlayers.GroupNorm) for m in model.modules())
    assert got.shape == want.shape == x.shape and got.is_contiguous(memory_format=CL)
    assert calls == convs + norms and falls == 0
    torch.testing.assert_close(got, want, atol=CL_ATOL, rtol=CL_ATOL)


def test_vae_channels_last_matches_nchw(vae_pair):
    """The tiny VAE's encode (the asymmetric pad) and decode on channels-last
    inputs against NCHW, within CL_ATOL; outputs NCHW-shaped with the
    channels innermost (the posterior's mean is a channel slice of the
    channels-last moments)."""
    port = vae_pair[2]
    rng = np.random.default_rng(12)
    img = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    with torch.no_grad():
        for fn, arg in ((lambda a: port.encode(a).mean, img), (port.decode, z)):
            want = fn(arg)
            got, calls, falls = _nhwc_calls(lambda: fn(arg.contiguous(memory_format=CL)))
            assert got.shape == want.shape and got.stride(1) == 1
            assert calls > 0 and falls == 0
            torch.testing.assert_close(got, want, atol=CL_ATOL, rtol=CL_ATOL)


@pytest.mark.parametrize("layout", ["nchw", "permuted_nhwc"])
def test_nchw_forward_with_autograd_takes_no_cached_filter(unet_pair, layout):
    """A forward and backward with autograd on outside the scope (the
    trainers' path), on an NCHW input or on the permuted view of an NHWC
    array the trainers hand the UNet (channels-last strides), adds nothing
    to the channels-last counter and caches no filter.  (PyTorch's CPU
    convolution picks its algorithm by the strides, so the two layouts agree
    within fp32 sums in another order, as before the channels-last path.)"""
    model = unet_pair[2]
    base = torch.randn((1, 8, 8, 4))
    x = (base.permute(0, 3, 1, 2) if layout == "permuted_nhwc"
         else base.permute(0, 3, 1, 2).contiguous()).requires_grad_(True)
    ctx = torch.randn((1, 77, 32))
    copies, cached = tcl.filter_copies, len(tcl._FILTERS)
    out, calls, falls = _nhwc_calls(lambda: model(x, torch.tensor([5]), ctx), scope=False)
    out.square().mean().backward()
    assert (calls, falls) == (0, 0) and x.grad is not None
    assert (tcl.filter_copies, len(tcl._FILTERS)) == (copies, cached)
    with torch.no_grad():
        want = model(base.permute(0, 3, 1, 2).contiguous(), torch.tensor([5]), ctx)
    torch.testing.assert_close(out.detach(), want, atol=1e-5, rtol=1e-5)


def _export_bytes(pipe, out_dir):
    from diffusion_finetuning_tpu_torch.io import safetensors_io
    from diffusion_finetuning_tpu_torch.models.hf_export import save_pretrained

    save_pretrained(pipe, str(out_dir / "hf"))
    safetensors_io.write_safetensors(pipe.unet.state_dict(), str(out_dir / "unet.safetensors"))
    return {str(p.relative_to(out_dir)): p.read_bytes()
            for p in sorted(out_dir.rglob("*")) if p.is_file()}


def test_saves_after_a_channels_last_call_are_unchanged(tmp_path):
    """A pipe's state dicts, a ``.safetensors`` of its UNet and its
    ``hf_export`` directory after channels-last UNet and VAE calls are byte
    for byte those from before: parameters stay NCHW and contiguous."""
    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline

    unet_p, vae_p, text_p = tiny_params()
    pipe = StableDiffusionPipeline(
        tunet.UNetConfig.tiny(), weights.unet_state_dict(unet_p, junet.UNetConfig.tiny()),
        tvae.VAEConfig.tiny(), weights.vae_state_dict(vae_p, jvae.VAEConfig.tiny()),
        CLIPTextConfig.tiny(), weights.text_state_dict(text_p, jclip.CLIPTextConfig.tiny()),
        CLIPTokenizer.tiny(["photo"]), device="cpu")
    sds = [{k: v.clone() for k, v in m.state_dict().items()} for m in (pipe.unet, pipe.vae)]
    (tmp_path / "before").mkdir()
    (tmp_path / "after").mkdir()
    before = _export_bytes(pipe, tmp_path / "before")
    x = torch.randn((2, 4, 16, 16)).contiguous(memory_format=CL)
    with torch.no_grad():
        _, calls, _ = _nhwc_calls(lambda: (pipe.unet(x, torch.tensor([3, 4]),
                                                     torch.randn((2, 77, 32))),
                                           pipe.vae.decode(x)))
    assert calls > 0
    for m, sd in zip((pipe.unet, pipe.vae), sds):
        now = m.state_dict()
        assert now.keys() == sd.keys()
        for k, v in now.items():
            assert v.is_contiguous() and v.stride() == sd[k].stride() and torch.equal(v, sd[k])
    assert _export_bytes(pipe, tmp_path / "after") == before


def test_in_place_weight_write_refreshes_its_cached_filter():
    """A conv weight rewritten in place is seen through the same cached
    channels-last copy, rewritten in place (a CUDA graph that read it reads
    the new values): at the next channels-last call, and at once where a
    graph's weights are written: a ``load_state_dict`` into the module and a
    ``graph.ParamBuffers`` refill (a merged adapter's weights); a freed
    weight drops its copy."""
    from diffusion_finetuning_tpu_torch.graph import ParamBuffers

    torch.manual_seed(5)
    conv = tlayers.Conv2d(8, 16, 3, padding=1)
    x = torch.randn((2, 8, 6, 6)).contiguous(memory_format=CL)
    with torch.no_grad(), tcl.scope():
        conv(x)
        cached = tcl.channels_last_filter(conv.weight)
        assert cached.is_contiguous(memory_format=CL) and torch.equal(cached, conv.weight)
        conv.weight.mul_(-2.0)
        got = conv(x)
        assert tcl.channels_last_filter(conv.weight) is cached
        torch.testing.assert_close(got, F.conv2d(x.contiguous(), conv.weight, conv.bias,
                                                 padding=1), atol=1e-5, rtol=1e-5)
        new = {k: torch.randn_like(v) for k, v in conv.state_dict().items()}
        conv.load_state_dict(new)
        assert torch.equal(cached, new["weight"]) and torch.equal(conv.weight, new["weight"])

        bufs = ParamBuffers({"w": conv.weight})
        buf_cached = tcl.channels_last_filter(bufs.buffers["w"])
        merged = conv.weight + 1.0
        assert bufs.fill({"w": merged}) == merged.numel() * merged.element_size()
        assert torch.equal(buf_cached, merged)
        assert tcl.channels_last_filter(bufs.buffers["w"]) is buf_cached
    key = id(conv.weight)
    del conv
    assert key not in tcl._FILTERS


def test_conv3x3_route_keeps_a_channels_last_layout(monkeypatch):
    """The opt-in fused-conv route (``layers.CONV_KERNEL``), which computes
    on NCHW, hands a channels-last layer its output back channels-last
    inside the scope, with the values of the NCHW call: the GroupNorm after
    it stays on the channels-last path."""
    from diffusion_finetuning_tpu_torch.ops import conv3x3 as tconv

    monkeypatch.setattr(tlayers, "CONV_KERNEL", True)
    monkeypatch.setattr(tconv, "routes", lambda x, w, stride, padding: w.shape[2:] == (3, 3))
    torch.manual_seed(6)
    conv = tlayers.LoRAConv2d(8, 16, 3, padding=1)
    x = torch.randn((2, 8, 6, 6))
    with torch.no_grad():
        want = conv(x)
        outside = conv(x.contiguous(memory_format=CL))
        with tcl.scope():
            got = conv(x.contiguous(memory_format=CL))
    assert want.is_contiguous() and got.is_contiguous(memory_format=CL)
    assert outside.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_chip_smoke_request_norms_match_a_channels_last_pipe(monkeypatch):
    """chip_smoke's ``request_norms`` (the ``group_norm`` launches it wants
    of a request) equal the NHWC GroupNorm calls of a tiny pipe's txt2img
    and img2img requests with the channels-last path on, as on the card:
    every GroupNorm of each UNet call and of the VAE decode (and encode)
    runs the NHWC GroupNorm once."""
    import chip_smoke
    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig
    from diffusion_finetuning_tpu_torch.ops import group_norm as tgn
    from diffusion_finetuning_tpu_torch.pipelines import pipeline as tpipe

    unet_p, vae_p, text_p = tiny_params()
    ucfg, vcfg = tunet.UNetConfig.tiny(), tvae.VAEConfig.tiny()
    pipe = tpipe.StableDiffusionPipeline(
        ucfg, weights.unet_state_dict(unet_p, junet.UNetConfig.tiny()),
        vcfg, weights.vae_state_dict(vae_p, jvae.VAEConfig.tiny()),
        CLIPTextConfig.tiny(), weights.text_state_dict(text_p, jclip.CLIPTextConfig.tiny()),
        CLIPTokenizer.tiny(["photo"]), device="cpu")
    monkeypatch.setattr(tpipe.StableDiffusionPipeline, "_card_scope",
                        lambda self: tcl.scope(True))
    monkeypatch.setattr(tpipe, "card_layout", lambda x: x.contiguous(memory_format=CL))
    seen = {"norms": 0, "unet": 0}
    real = tgn.group_norm

    def counted(*a, **kw):
        seen["norms"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tgn, "group_norm", counted)
    hook = pipe.unet.register_forward_hook(
        lambda *_: seen.__setitem__("unet", seen["unet"] + 1))
    img = np.random.default_rng(13).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    try:
        for encode, request in ((False, lambda: pipe("photo", num_inference_steps=3, seed=1,
                                                     height=32, width=32)),
                                (True, lambda: pipe.img2img("photo", img, strength=0.75,
                                                            num_inference_steps=4, seed=1))):
            seen.update(norms=0, unet=0)
            request()
            assert seen["unet"] > 0
            assert seen["norms"] == chip_smoke.request_norms(ucfg, vcfg, seen["unet"], encode)
    finally:
        hook.remove()


def test_chip_smoke_group_norm_calls_match_a_traced_forward(unet_pair, vae_pair):
    """chip_smoke's GroupNorm shape lists (its kernel rows' calls per step)
    equal the GroupNorm calls a forward makes, at the tiny configs."""
    import chip_smoke

    def traced(model, fn):
        seen = {}

        def hook(mod, args, kwargs):
            b, c, h, w = args[0].shape
            key = (b, c, h, w, kwargs.get("add") is not None, bool(kwargs.get("silu")))
            seen[key] = seen.get(key, 0) + 1

        hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
                 for m in model.modules() if isinstance(m, tlayers.GroupNorm)]
        try:
            with torch.no_grad():
                fn()
        finally:
            for h in hooks:
                h.remove()
        return seen

    unet, vae = unet_pair[2], vae_pair[2]
    x = torch.randn((2, 4, 16, 16))
    assert traced(unet, lambda: unet(x, torch.tensor([1, 2]), torch.randn((2, 77, 32)))) == \
        chip_smoke.unet_group_norm_calls(tunet.UNetConfig.tiny(), 2, 16)
    assert traced(vae, lambda: vae.decode(torch.randn((3, 4, 8, 8)))) == \
        chip_smoke.vae_decoder_group_norm_calls(tvae.VAEConfig.tiny(), 3, 8)
