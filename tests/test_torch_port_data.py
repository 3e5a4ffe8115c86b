"""The port's data pipeline, LoRA addressing, warm start, checkpoints and
attention router against the JAX package's, on the CPU.

* ``data/``: for the same folder and seed the port's datasets and
  ``DataLoader`` give JAX's batches byte for byte (pixels, token ids,
  masks): PTI captions from templates with colour jitter and flips,
  DreamBooth with prior preservation, the face mask; the port's native
  loader (built into ``build/``) against the PIL path, within 2.5/127.5 as
  JAX's own test holds its loader.
* ``lora_targets_from_module`` on the port's tiny UNet and CLIP gives the
  JAX package's target lists in order; on a toy model, JAX's function on the
  same model written in Flax.
* ``inject_trainable_lora(loras=...)``: the same tree as JAX's from one
  ``.pt`` file, exactly.
* ``training/checkpoint.py``: a round trip is bit-equal, in place; a
  drifted structure is refused.
* ``ops/attention.py``: overrides resolve as JAX's do, and one turned off
  sends its shape's calls to ``plain_attention``.
"""

import os
import warnings

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from diffusion_finetuning_tpu import lora as jlora
from diffusion_finetuning_tpu.data import dataset as jds
from diffusion_finetuning_tpu.data.tokenizer import CLIPTokenizer as JTokenizer
from diffusion_finetuning_tpu.ops import attention as jattn

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.data import dataset as tds
from diffusion_finetuning_tpu_torch.data import native_loader as tnl
from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer as TTokenizer
from diffusion_finetuning_tpu_torch.ops import attention as tattn
from diffusion_finetuning_tpu_torch.training import checkpoint as tckpt

WORDS = ["photo", "of", "sks", "dog"]


def _face(path, size=(64, 48), shift=0):
    img = Image.new("RGB", size, (90, 120, 150))
    d = ImageDraw.Draw(img)
    d.ellipse([16 + shift, 8, 44 + shift, 42], fill=(224, 172, 140))
    img.save(path)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """An instance folder (random PNG/JPEG, odd sizes, a face) and a class
    folder."""
    root = tmp_path_factory.mktemp("port_data")
    inst, cls = root / "inst", root / "cls"
    inst.mkdir()
    cls.mkdir()
    rng = np.random.default_rng(3)
    for i, (w, h) in enumerate([(40, 32), (32, 40), (32, 32)]):
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(inst / f"a photo of sks_{i}.png")
    Image.fromarray((rng.random((24, 24, 3)) * 255).astype(np.uint8)).save(
        inst / "sks dog.jpg", quality=95)
    _face(str(inst / "sks face.png"))
    for i in range(3):
        Image.fromarray((rng.random((20, 20, 3)) * 255).astype(np.uint8)).save(
            cls / f"class_{i}.png")
    return str(inst), str(cls)


def _batches(mod, tok_cls, make, n=6, batch_size=2, seed=11):
    tok = tok_cls.tiny(WORDS)
    ds = make(mod, tok)
    loader = mod.DataLoader(ds, batch_size, tok.encoder[tok.pad_token], seed=seed)
    out = []
    while len(out) < n:
        out += list(loader)
    return out[:n]


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            assert x[k].tobytes() == y[k].tobytes(), k


def test_pti_captions_with_templates_and_jitter_match_jax(folders):
    inst, _ = folders

    def make(mod, tok):
        return mod.PivotalTuningDatasetCapation(
            instance_data_root=inst, token_map={"DUMMY": "<s1><s2>"}, use_template="object",
            tokenizer=tok, size=16, color_jitter=True, seed=5)

    _assert_same_batches(_batches(tds, TTokenizer, make), _batches(jds, JTokenizer, make))


def test_pti_filename_captions_and_face_mask_match_jax(folders):
    inst, _ = folders

    def make(mod, tok):
        return mod.PivotalTuningDatasetCapation(
            instance_data_root=inst, token_map={"sks": "<s1>"}, tokenizer=tok, size=16,
            use_face_segmentation_condition=True, blur_amount=3, seed=6)

    with warnings.catch_warnings():  # an image with no face warns
        warnings.simplefilter("ignore")
        got = _batches(tds, TTokenizer, make, n=5, batch_size=1)
        want = _batches(jds, JTokenizer, make, n=5, batch_size=1)
    _assert_same_batches(got, want)
    assert any(b["mask"].any() for b in got), "the drawn face gave no mask"


def test_dreambooth_prior_preservation_matches_jax(folders):
    inst, cls = folders

    def make(mod, tok):
        return mod.DreamBoothDataset(
            instance_data_root=inst, instance_prompt="a photo of sks dog", tokenizer=tok,
            class_data_root=cls, class_prompt="a photo of dog", size=16, center_crop=True,
            h_flip=True, resize=True, seed=7)

    got = _batches(tds, TTokenizer, make)
    _assert_same_batches(got, _batches(jds, JTokenizer, make))
    assert got[0]["pixel_values"].shape == (4, 16, 16, 3)  # [instance; class]
    assert got[0]["pixel_values"].dtype == np.uint8


def test_dreambooth_ti_dataset_matches_jax(folders):
    inst, cls = folders

    def make(mod, tok):
        return mod.DreamBoothTiDataset(
            instance_data_root=inst, learnable_property="object", placeholder_token="<krk>",
            stochastic_attribute="sks,dog,photo", tokenizer=tok, class_data_root=cls,
            class_prompt="a photo of dog", size=16, color_jitter=True, seed=8)

    _assert_same_batches(_batches(tds, TTokenizer, make), _batches(jds, JTokenizer, make))


def test_native_loader_builds_outside_native_and_matches_pil(folders):
    if not tnl.available():
        pytest.skip(f"the native loader cannot be built here: {tnl.unavailable_reason}")
    inst, _ = folders
    assert "build" in str(tnl.library_path()) and tnl.library_path().exists()
    paths = sorted(os.path.join(inst, f) for f in os.listdir(inst))
    for p in paths:
        ours = tnl.load_image(p, 16)
        img = Image.open(p).convert("RGB")
        ref = tds.to_normalized_array(tds.center_crop(tds.resize_short_side(img, 16), 16))
        assert ours.shape == (16, 16, 3)
        assert np.abs(ours - ref).max() <= 2.5 / 127.5
    batch = tnl.load_batch(paths, 16, flips=[True] * len(paths))
    for p, b in zip(paths, batch):
        np.testing.assert_array_equal(b, tnl.load_image(p, 16)[:, ::-1])


def _fields(targets):
    return [(t.path, t.in_features, t.out_features, t.ancestor, t.kernel_size)
            for t in targets]


def _tiny_models():
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from diffusion_finetuning_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig

    with torch.device("meta"):
        return (UNet2DConditionModel(UNetConfig.tiny()),
                CLIPTextModel(CLIPTextConfig.tiny()))


@pytest.mark.parametrize("which", ["unet", "unet_conv", "text"])
def test_lora_targets_from_module_equals_jax_target_lists(which):
    from diffusion_finetuning_tpu.models import clip_text as jclip
    from diffusion_finetuning_tpu.models import unet as junet

    unet, text = _tiny_models()
    if which == "unet":
        got = tlora.lora_targets_from_module(unet,
                                             target_replace_module=tlora.DEFAULT_TARGET_REPLACE)
        want = jlora.filter_targets(junet.unet_lora_targets(junet.UNetConfig.tiny()),
                                    jlora.DEFAULT_TARGET_REPLACE)
    elif which == "unet_conv":
        got = [t for t in tlora.lora_targets_from_module(
            unet, target_replace_module={"ResnetBlock2D"}, include_conv=True) if t.is_conv]
        want = junet.unet_conv_lora_targets(junet.UNetConfig.tiny())
        key = lambda t: t.path  # noqa: E731 -- JAX's list is per-block, not preorder
        got, want = sorted(got, key=key), sorted(want, key=key)
    else:
        got = tlora.lora_targets_from_module(text, target_replace_module={"CLIPAttention"})
        want = jclip.text_encoder_lora_targets(jclip.CLIPTextConfig.tiny())
    assert _fields(got) == _fields(want)
    assert len({t.path for t in got}) == len(got)
    for t in got:  # the paths address the port's modules
        model = text if which == "text" else unet
        layer = model.get_submodule(tlora.module_name(t.path, model.lora_prefix))
        assert isinstance(layer, (torch.nn.Linear, torch.nn.Conv2d))


def test_lora_targets_from_module_toy_model_matches_jax():
    """A toy model in torch and in Flax, class names matched, a layer under
    two matched ancestors, an untargeted dense: the same targets in order."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from torch import nn

    class CrossAttention(nn.Module):
        def __init__(self):
            super().__init__()
            self.to_q = nn.Linear(8, 8, bias=False)
            self.to_k = nn.Linear(8, 8, bias=False)
            self.to_out = nn.Linear(8, 8)

    class Outer(nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = CrossAttention()
            self.own = nn.Linear(8, 4)

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Linear(6, 8)
            self.outer = Outer()
            self.attn = CrossAttention()

    class JCross(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            q = fnn.Dense(8, name="to_q", use_bias=False)(x)
            k = fnn.Dense(8, name="to_k", use_bias=False)(x)
            return fnn.Dense(8, name="to_out")(q * k)

    JCross.__name__ = "CrossAttention"

    class JOuter(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(4, name="own")(JCross(name="inner")(x))

    JOuter.__name__ = "Outer"

    class JModel(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Dense(8, name="embed")(x)
            return JOuter(name="outer")(x), JCross(name="attn")(x)

    replace = {"Outer", "CrossAttention"}
    got = tlora.lora_targets_from_module(Model(), target_replace_module=replace)
    want = jlora.lora_targets_from_module(JModel(), jax.random.PRNGKey(0), jnp.zeros((1, 6)),
                                          target_replace_module=replace)
    assert _fields(got) == _fields(want)
    assert [t.path for t in got][:4] == [("outer", "inner", "to_q"), ("outer", "inner", "to_k"),
                                         ("outer", "inner", "to_out"), ("outer", "own")]


def test_warm_start_from_pt_equals_jax(tmp_path):
    from diffusion_finetuning_tpu.models import unet as junet

    from tests.torch_port_fixtures import numpy_lora_tree, to_jax

    targets = jlora.filter_targets(junet.unet_lora_targets(junet.UNetConfig.tiny()),
                                   jlora.DEFAULT_TARGET_REPLACE)
    path = str(tmp_path / "w.pt")
    jlora.save_lora_weight(to_jax(numpy_lora_tree(targets, rank=2, seed=4)), targets, path)
    want = jlora.inject_trainable_lora(targets, None, r=4, loras=path)
    got = tlora.inject_trainable_lora(targets, None, r=4, loras=path)
    flat = tlora.lora_tree_to_flat(got, targets)
    for g, w in zip(flat, jlora.lora_tree_to_flat(want, targets)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    again = tlora.inject_trainable_lora(targets, torch.Generator(), loras=flat, scale=0.5)
    for (_, a), (_, b) in zip(tlora.lora_leaves(again), tlora.lora_leaves(got)):
        assert torch.equal(a["up"], b["up"]) and float(a["scale"]) == 0.5
    with pytest.raises(ValueError):
        tlora.inject_trainable_lora(targets[:-1], None, loras=path)


def _train_state(seed, accum=2, text=True):
    from diffusion_finetuning_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                                 text_encoder_lora_targets)
    from diffusion_finetuning_tpu_torch.training.optim import ParamGroup, multi_group_optimizer
    from diffusion_finetuning_tpu_torch.training.train_step import init_train_state

    g = torch.Generator().manual_seed(seed)
    targets = text_encoder_lora_targets(CLIPTextConfig.tiny())
    tree = tlora.inject_trainable_lora(targets, g, r=2)
    groups = {"text_lora": ParamGroup(lr=1e-3), "ti_embeddings": ParamGroup(lr=1e-2)}
    opt = multi_group_optimizer(groups, grad_accum_steps=accum, max_grad_norm=1.0)
    emb = torch.randn((40, 32), generator=g)
    return init_train_state(opt, text_lora=tree if text else None, ti_embeddings=emb,
                            device="cpu")


def test_checkpoint_round_trip_is_bit_equal_and_in_place(tmp_path):
    state = _train_state(0)
    named = tckpt.named_tensors(state)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in named.values():  # every tensor takes a distinct value
            t.copy_(torch.randint(-100, 100, t.shape, generator=g).to(t.dtype))
    state["step"] = 7
    saved = {k: t.clone() for k, t in named.items()}
    for step in (3, 5, 7, 9):
        path = tckpt.save_train_state(str(tmp_path), state, step=step, keep=3)
    assert sorted(os.listdir(tmp_path)) == ["step_5", "step_7", "step_9"]
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None

    target = _train_state(2)
    ids = {k: id(t) for k, t in tckpt.named_tensors(target).items()}
    out = tckpt.restore_train_state(path, target)
    assert out is target and target["step"] == 7
    restored = tckpt.named_tensors(target)
    assert {k: id(t) for k, t in restored.items()} == ids  # copied in, not rebound
    assert restored.keys() == saved.keys()
    for k, t in restored.items():
        assert t.dtype == saved[k].dtype and torch.equal(t, saved[k]), k
    assert target["params"]["ti_embeddings"].requires_grad
    assert target["static"]["orig_embeddings"] is not None  # static untouched


@pytest.mark.parametrize("drift", ["no_text_lora", "no_accumulation"])
def test_checkpoint_refuses_a_drifted_structure(tmp_path, drift):
    path = tckpt.save_train_state(str(tmp_path), _train_state(0), step=1)
    target = _train_state(0, accum=1) if drift == "no_accumulation" else _train_state(0,
                                                                                      text=False)
    before = [t.clone() for t in tckpt.named_tensors(target).values()]
    with pytest.raises(ValueError, match="different state structure"):
        tckpt.restore_train_state(path, target)
    assert all(torch.equal(a, b) for a, b in zip(before, tckpt.named_tensors(target).values()))


def test_attention_overrides_resolve_as_jax_and_route_to_plain(monkeypatch):
    settings = [(dict(head_dim=4), False), (dict(seq_len_q=16, head_dim=4), True),
                (dict(seq_len_q=64), False), (dict(seq_len_q=64, head_dim=8), None)]
    try:
        for kw, on in settings:
            jattn.set_flash_override(**kw, enabled=on)
            tattn.set_flash_override(**kw, enabled=on)
        for sq in (16, 64, 256):
            for d in (4, 8):
                assert tattn._override_for(sq, d) == jattn._override_for(sq, d)
    finally:
        jattn.clear_flash_overrides()
        tattn.clear_flash_overrides()

    calls = []
    real_plain = tattn.plain_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda q, k, v, heads, scale=None: calls.append(("flash", q.shape[1]))
                        or real_plain(q, k, v, heads, scale))
    monkeypatch.setattr(tattn, "plain_attention",
                        lambda q, k, v, heads, scale=None: calls.append(("plain", q.shape[1]))
                        or real_plain(q, k, v, heads, scale))
    g = torch.Generator().manual_seed(0)
    q16, q64 = (torch.randn((1, s, 8), generator=g) for s in (16, 64))
    try:
        tattn.set_flash_override(seq_len_q=64, head_dim=4, enabled=False)
        out = tattn.attention(q64, q64, q64, heads=2)
        tattn.attention(q16, q16, q16, heads=2)
        routing = tattn.routing()
    finally:
        tattn.clear_flash_overrides()
    assert calls == [("plain", 64), ("flash", 16)]
    torch.testing.assert_close(out, real_plain(q64, q64, q64, 2), rtol=0, atol=0)
    assert routing != tattn.routing()  # a graph key sees the override
    tattn.set_flash_enabled(False)
    try:
        calls.clear()
        tattn.attention(q16, q16, q16, heads=2)
        assert calls == [("plain", 16)]
    finally:
        tattn.set_flash_enabled(True)


def test_attention_router_sends_no_call_off_the_cpu_to_plain(monkeypatch):
    """A call the router turns away goes to plain_attention only on the CPU:
    a tensor elsewhere (here ``meta``, standing for the card) raises, naming
    the shape, and reaches neither path."""
    calls = []
    monkeypatch.setattr(tattn, "plain_attention", lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(tattn, "flash_attention", lambda *a, **k: calls.append("flash"))
    q = torch.empty((1, 64, 8), device="meta")
    try:
        tattn.set_flash_override(seq_len_q=64, head_dim=4, enabled=False)
        with pytest.raises(RuntimeError, match="seq_len_q=64, head_dim=4"):
            tattn.attention(q, q, q, heads=2)
        tattn.clear_flash_overrides()
        tattn.set_flash_enabled(False)
        with pytest.raises(RuntimeError, match="seq_len_q=64, head_dim=4"):
            tattn.attention(q, q, q, heads=2)
    finally:
        tattn.clear_flash_overrides()
        tattn.set_flash_enabled(True)
    assert calls == []
    tattn.attention(q, q, q, heads=2)
    assert calls == ["flash"]


def test_profiling_step_timer_logger_and_trace(tmp_path):
    """utils/profiling.py: rolling step statistics, a scalar logger whose
    sinks are optional (a tfevents file where tensorboard is importable),
    and a torch.profiler trace written as a Chrome trace."""
    from diffusion_finetuning_tpu_torch.utils import profiling

    timer = profiling.StepTimer(window=2)
    assert timer.tick() is None and timer.steps_per_sec == 0.0
    for _ in range(3):
        assert timer.tick() >= 0
    assert len(timer.times) == 2 and timer.steps_per_sec > 0

    logger = profiling.MetricLogger(log_dir=str(tmp_path / "tb"))
    logger.log({"loss": 0.5, "lr": 1e-4}, step=3)
    logger.close()
    if logger._tb is not None:
        assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "tb"))
    profiling.MetricLogger().log({"loss": 1.0}, step=0)  # no sink: a no-op

    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    (trace,) = os.listdir(tmp_path / "trace")
    assert trace.endswith(".json") and os.path.getsize(tmp_path / "trace" / trace) > 0
