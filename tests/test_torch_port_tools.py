"""The port's tools against the JAX package's on one directory, on the CPU:
``to_ckpt_v2``, ``cli_pt_to_safetensors``, ``cli_lora_add`` (lpl, upl,
upl-ckpt-v2), ``cli_svd`` (``lora_distill``) and ``utils/eval``, with the
PTI trainer's CLIP evaluation wired to it.

Both packages read the port's tiny pipe written by ``save_pretrained``
(``torch_port_fixtures.trainer_dirs``), so no JAX model init is compiled.
What is held, and how closely:

* ``.ckpt`` conversion: the same keys, dtypes and values, bit for bit, and
  each package reads the other's file;
* ``pt_to_safetensors``: the output file byte-identical to JAX's;
* ``lpl``: the merged tensors bit-equal to JAX's (fp32 interpolation, cast
  back to the first file's dtype);
* ``upl``: each merged weight within 1e-6 of JAX's, relative to the
  tensor's largest magnitude (numpy's and torch's fp32 products of a pair
  may round differently); ``upl-ckpt-v2``: the same keys and dtypes, each
  fp16 value equal to JAX's or one fp16 ulp from it;
* ``lora_distill``: JAX's reconstruction test mirrored (rank-2 deltas,
  ``U @ Vh`` within 2e-3), ``svd_pair`` against ``np.linalg.svd`` pair by
  pair after sign alignment (relative Frobenius error 1e-5), and
  ``clamp_pair`` on JAX's factors equal to JAX's ``_distill_one`` bit for
  bit (the module's sign contract);
* eval: ``text_img_alignment`` and ``image_grid`` against JAX's;
  ``evaluate_pipe`` with a stub CLIP set against JAX's
  ``text_img_alignment`` of the stub's embeddings of the port's images.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_finetuning_tpu import cli_lora_add as jadd
from diffusion_finetuning_tpu import cli_pt_to_safetensors as jpt
from diffusion_finetuning_tpu import cli_svd as jsvd
from diffusion_finetuning_tpu import to_ckpt_v2 as jckpt
from diffusion_finetuning_tpu.io import torch_pickle
from diffusion_finetuning_tpu.utils import eval as jeval

from diffusion_finetuning_tpu_torch import cli_lora_add as tadd
from diffusion_finetuning_tpu_torch import cli_pt_to_safetensors as tpt
from diffusion_finetuning_tpu_torch import cli_svd as tsvd
from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch import to_ckpt_v2 as tckpt
from diffusion_finetuning_tpu_torch.models import hf_export, hf_loading
from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline
from diffusion_finetuning_tpu_torch.utils import eval as teval
from diffusion_finetuning_tpu_torch.utils.cli import Fire

from tests.torch_port_fixtures import small_images, trainer_dirs  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return trainer_dirs(tmp_path_factory)


@pytest.fixture(scope="module")
def pipe(dirs):
    return StableDiffusionPipeline.from_pretrained(dirs["model"], device="cpu")


def _targets(pipe, name):
    return pipe.lora_targets(name, tlora.DEFAULT_TARGET_REPLACE if name == "unet"
                             else tlora.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)


def _flat(targets, rank, seed, dtype=torch.float16):
    g = torch.Generator().manual_seed(seed)
    out = []
    for t in targets:
        out += [torch.randn(t.out_features, rank, generator=g).to(dtype),
                torch.randn(rank, t.in_features, generator=g).to(dtype)]
    return out


# -- to_ckpt_v2 ----------------------------------------------------------------


@pytest.mark.parametrize("as_half", [False, True], ids=["fp32", "fp16"])
def test_convert_to_ckpt_matches_jax(dirs, tmp_path, as_half):
    want_path, got_path = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jckpt.convert_to_ckpt(dirs["model"], want_path, as_half=as_half)
    tckpt.convert_to_ckpt(dirs["model"], got_path, as_half=as_half)
    want = torch.load(want_path, weights_only=True)["state_dict"]  # torch reads JAX's
    got = torch_pickle.load(got_path)["state_dict"]  # JAX reads the port's
    assert list(got) == list(want) and len(want) > 100
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.numpy().dtype == (np.float16 if as_half else np.float32), k
        assert g.shape == tuple(w.shape) and g.tobytes() == w.numpy().tobytes(), k
    assert want["first_stage_model.encoder.mid.attn_1.q.weight"].ndim == 4


# -- cli_pt_to_safetensors -----------------------------------------------------


def test_pt_to_safetensors_byte_identical(pipe, tmp_path):
    """A LoRA pair (.pt and .text_encoder.pt) plus a TI file, ``--unet.rank
    2`` given on the port's command line."""
    pt = str(tmp_path / "lora_weight.pt")
    torch.save(_flat(_targets(pipe, "unet"), 2, 4), pt)
    torch.save(_flat(_targets(pipe, "text_encoder"), 4, 5), str(tmp_path /
                                                                "lora_weight.text_encoder.pt"))
    ti = str(tmp_path / "lora_weight.ti.pt")
    torch.save({"<s1>": torch.randn(32, generator=torch.Generator().manual_seed(6))}, ti)
    paths = [pt, str(tmp_path / "lora_weight.text_encoder.pt"), ti]
    want, got = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jpt.convert(*paths, outpath=want, **{"unet.rank": 2})
    Fire(tpt.convert, argv=paths + ["--outpath", got, "--unet.rank", "2"])
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="already exists"):
        tpt.convert(pt, outpath=got)


# -- cli_lora_add ----------------------------------------------------------------


@pytest.mark.parametrize("with_text", [False, True], ids=["unet", "with_text"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32], ids=["fp16", "fp32"])
def test_lora_add_lpl_bit_equal(pipe, tmp_path, dtype, with_text):
    paths = {}
    for i, name in enumerate(("a", "b")):
        paths[name] = str(tmp_path / f"{name}.pt")
        torch.save(_flat(_targets(pipe, "unet"), 2, 10 + i, dtype), paths[name])
        torch.save(_flat(_targets(pipe, "text_encoder"), 2, 20 + i, dtype),
                   tlora._text_lora_path(paths[name]))
    want, got = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    jadd.add(paths["a"], paths["b"], want, alpha=0.3, mode="lpl", with_text_lora=with_text)
    tadd.add(paths["a"], paths["b"], got, alpha=0.3, mode="lpl", with_text_lora=with_text)
    pairs = [(want, got)] + ([(tlora._text_lora_path(want), tlora._text_lora_path(got))]
                             if with_text else [])
    assert os.path.exists(tlora._text_lora_path(got)) == with_text
    for w, g in pairs:
        wl, gl = torch.load(w, weights_only=True), torch.load(g, weights_only=True)
        assert len(wl) == len(gl) > 0
        for a, b in zip(wl, gl):
            assert a.dtype == b.dtype == dtype and torch.equal(a, b)


def _merged_sds(model_dir):
    comps = hf_loading.load_pipeline_components(model_dir)
    return {name: comps[f"{name}_state_dict"] for name in ("unet", "vae", "text")}


def test_lora_add_upl_matches_jax(dirs, pipe, tmp_path):
    lora = str(tmp_path / "w.pt")
    torch.save(_flat(_targets(pipe, "unet"), 2, 1), lora)
    torch.save(_flat(_targets(pipe, "text_encoder"), 2, 2), tlora._text_lora_path(lora))
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    jadd.add(dirs["model"], lora, want, alpha=0.8, mode="upl", with_text_lora=True)
    tadd.add(dirs["model"], lora, got, alpha=0.8, mode="upl", with_text_lora=True,
             device="cpu")
    base, w_sds, g_sds = _merged_sds(dirs["model"]), _merged_sds(want), _merged_sds(got)
    moved = 0
    for name in ("unet", "vae", "text"):
        assert w_sds[name].keys() == g_sds[name].keys()
        for k, w in w_sds[name].items():
            g = g_sds[name][k]
            assert g.dtype == w.dtype == torch.float32
            assert (g - w).abs().max() <= 1e-6 * w.abs().max(), (name, k)
            moved += not torch.equal(g, base[name][k])
    assert moved == len(_targets(pipe, "unet")) + len(_targets(pipe, "text_encoder"))


def test_lora_add_upl_ckpt_v2_matches_jax(dirs, pipe, tmp_path):
    lora = str(tmp_path / "w.pt")
    torch.save(_flat(_targets(pipe, "unet"), 2, 3), lora)
    want, got = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jadd.add(dirs["model"], lora, want, alpha=0.5, mode="upl-ckpt-v2")
    tadd.add(dirs["model"], lora, got, alpha=0.5, mode="upl-ckpt-v2", device="cpu")
    assert not os.path.exists(got + ".tmp")
    w_sd = torch.load(want, weights_only=True)["state_dict"]
    g_sd = torch.load(got, weights_only=True)["state_dict"]
    assert sorted(w_sd) == sorted(g_sd)
    for k, w in w_sd.items():
        g = g_sd[k]
        assert g.dtype == w.dtype == torch.float16 and g.shape == w.shape, k
        # one fp16 ulp: neighbouring values are one apart as int16 (same sign)
        ulps = (g.view(torch.int16).int() - w.view(torch.int16).int()).abs()
        assert int(ulps.max()) <= 1 and bool(((g == w) | (g.sign() == w.sign())).all()), k


# -- cli_svd (lora_distill) ------------------------------------------------------


def test_svd_distill_reconstructs_delta(dirs, pipe, tmp_path):
    """JAX's test_svd_distill_reconstructs_delta on the port: rank-2 deltas
    on every UNet and text target, distilled at rank 4 with clamp 1.0."""
    rng = np.random.default_rng(3)
    tuned = StableDiffusionPipeline.from_pretrained(dirs["model"], device="cpu")
    deltas = {}
    for name in ("unet", "text_encoder"):
        model = getattr(tuned, name)
        sd = model.state_dict()
        for t in _targets(pipe, name):
            u = rng.standard_normal((t.out_features, 2)).astype(np.float32) * 0.01
            v = rng.standard_normal((2, t.in_features)).astype(np.float32) * 0.01
            deltas[(name, t.path)] = u @ v
            key = tlora.module_name(t.path, model.lora_prefix) + ".weight"
            sd[key] = sd[key] + torch.from_numpy(u @ v)
        model.load_state_dict(sd)
    tuned_dir = str(tmp_path / "tuned")
    hf_export.save_pretrained(tuned, tuned_dir, source_dir=dirs["model"])

    save_path = str(tmp_path / "svd.pt")
    Fire(tsvd.svd_distill, argv=[tuned_dir, dirs["model"], "--rank", "4", "--clamp_quantile",
                                 "1.0", "--device", "cpu", "--save_path", save_path])
    for name, path in (("unet", save_path), ("text_encoder", str(tmp_path / "svd.text_encoder.pt"))):
        flat = torch.load(path, weights_only=True)
        targets = _targets(pipe, name)
        assert len(flat) == 2 * len(targets)
        for i, t in enumerate(targets):
            U, Vh = flat[2 * i].numpy(), flat[2 * i + 1].numpy()
            assert U.shape == (t.out_features, 4) and Vh.shape == (4, t.in_features)
            np.testing.assert_allclose(U @ Vh, deltas[(name, t.path)], atol=2e-3)


def test_svd_pair_matches_numpy_after_sign_alignment():
    """Each (U S, Vh) pair against numpy's within a relative Frobenius error
    of 1e-5 once its sign is aligned; the product needs no alignment.  The
    deltas are what a fine-tune gives: rank 4 with separated singular values
    (8, 4, 2, 1), plus a full-rank 1e-3 residue; a pair's error grows as the
    gap to its neighbours shrinks, whoever computes it."""
    rng = np.random.default_rng(0)
    for shape in ((64, 32), (40, 96), (320, 768)):
        u = np.linalg.qr(rng.standard_normal((shape[0], 4)))[0]
        v = np.linalg.qr(rng.standard_normal((shape[1], 4)))[0]
        delta = ((u * np.array([8.0, 4.0, 2.0, 1.0])) @ v.T
                 + 1e-3 * rng.standard_normal(shape)).astype(np.float32)
        U, Vh = tsvd.svd_pair(torch.from_numpy(delta), 4)
        nu, ns, nvh = np.linalg.svd(delta, full_matrices=False)
        want_u, want_vh = nu[:, :4] * ns[:4][None, :], nvh[:4]
        for j in range(4):
            sign = np.sign(np.dot(U[:, j].numpy(), want_u[:, j]))
            for got, want in ((U[:, j].numpy() * sign, want_u[:, j]),
                              (Vh[j].numpy() * sign, want_vh[j])):
                assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
        prod = (U @ Vh).numpy()
        want_prod = want_u @ want_vh
        assert np.linalg.norm(prod - want_prod) <= 1e-5 * np.linalg.norm(want_prod)


@pytest.mark.parametrize("q", [0.99, 0.9, 0.5, 1.0, 0.0])
def test_clamp_pair_bit_equal_to_jax(q):
    """``clamp_pair`` on the factors JAX's ``_distill_one`` builds equals its
    output bit for bit, over shapes whose quantile index is fractional."""
    rng = np.random.default_rng(int(q * 100))
    for shape in ((77, 13), (320, 40), (1280, 96)):
        delta = (rng.standard_normal(shape) * rng.uniform(0.1, 3.0)).astype(np.float32)
        U, S, Vh = np.linalg.svd(delta, full_matrices=False)
        U, Vh = U[:, :4] * S[:4][None, :], Vh[:4, :]
        want_u, want_vh = jsvd._distill_one(delta, 4, q)
        got_u, got_vh = tsvd.clamp_pair(torch.from_numpy(U), torch.from_numpy(Vh), q)
        assert got_u.numpy().tobytes() == want_u.tobytes()
        assert got_vh.numpy().tobytes() == want_vh.tobytes()
        if 0.5 <= q < 1.0:  # the clamp bites
            assert (got_u.abs().max() < np.abs(U).max()) or (got_vh.abs().max()
                                                              < np.abs(Vh).max())


def test_svd_distill_refuses_without_a_card(dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; tests/test_torch_port_cuda.py hides it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsvd.svd_distill(dirs["model"], dirs["model"], save_path=str(tmp_path / "x.pt"))
    assert not os.path.exists(tmp_path / "x.pt")


# -- utils/eval ------------------------------------------------------------------


def test_text_img_alignment_and_grid_match_jax():
    rng = np.random.default_rng(1)
    img, txt, tgt = (rng.standard_normal(s).astype(np.float32)
                     for s in ((5, 16), (5, 16), (3, 16)))
    assert teval.text_img_alignment(img, txt, tgt) == jeval.text_img_alignment(img, txt, tgt)
    assert teval.EXAMPLE_PROMPTS == jeval.EXAMPLE_PROMPTS
    ims = [Image.fromarray(rng.integers(0, 256, (8, 6, 3), dtype=np.uint8)) for _ in range(5)]
    for rows, cols in ((None, None), (1, 5), (2, None), (None, 3)):
        assert (np.asarray(teval.image_grid(ims, rows, cols)).tobytes()
                == np.asarray(jeval.image_grid(ims, rows, cols)).tobytes())


class _StubProcessor:
    """transformers' CLIPProcessor's call: images -> pixel_values; keeps
    what it was given."""

    def __init__(self):
        self.seen = []

    def __call__(self, images, return_tensors="pt"):
        ims = images if isinstance(images, list) else [images]
        self.seen.append(ims)
        px = np.stack([np.asarray(im.convert("RGB").resize((8, 8)), np.float32) / 255
                       for im in ims])
        return {"pixel_values": torch.from_numpy(px).flatten(1)}


class _StubTokenizer:
    def __call__(self, texts, padding=True, return_tensors="pt"):
        ids = [[ord(c) % 97 for c in t] for t in texts]
        n = max(len(i) for i in ids)
        return {"input_ids": torch.tensor([i + [0] * (n - len(i)) for i in ids])}


def _stub_clip():
    torch.manual_seed(0)
    vis_proj, emb = torch.nn.Linear(192, 16), torch.nn.Embedding(97, 16)
    vis = lambda pixel_values: types.SimpleNamespace(image_embeds=vis_proj(pixel_values))
    text = lambda input_ids: types.SimpleNamespace(text_embeds=emb(input_ids).mean(1))
    return text, _StubTokenizer(), vis, _StubProcessor()


def test_evaluate_pipe_with_a_stub_clip_set(dirs, pipe, small_images):
    """The port's pipe generates; the result equals JAX's alignment of the
    stub's embeddings of the very images the port generated."""
    clip = _stub_clip()
    targets = [Image.open(os.path.join(dirs["inst"], f)) for f in sorted(os.listdir(dirs["inst"]))]
    got = teval.evaluate_pipe(pipe, targets, class_token="dog", learnt_token="sks",
                              clip_model_sets=clip, n_test=2, n_step=2)
    text, tok, vis, proc = clip
    images = [ims[0] for ims in proc.seen[:2]]
    assert len(images) == 2 and images[0].size == (16, 16)
    with torch.no_grad():
        img_e = np.concatenate([vis(**proc(images=im)).image_embeds.numpy() for im in images])
        prompts = [p.replace("<obj>", "dog") for p in teval.EXAMPLE_PROMPTS[:2]]
        txt_e = np.concatenate([text(**tok([p])).text_embeds.numpy() for p in prompts])
        tgt_e = vis(**proc(images=targets)).image_embeds.numpy()
    want = jeval.text_img_alignment(img_e, txt_e, tgt_e)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got["text_alignment_avg"], got["image_alignment_avg"]],
                               [want["text_alignment_avg"], want["image_alignment_avg"]],
                               rtol=1e-6)


def test_visualize_progress_over_two_lora_files(dirs, pipe, tmp_path, small_images):
    paths = []
    for i in range(2):
        g = torch.Generator().manual_seed(30 + i)
        tree = tlora.inject_trainable_lora(_targets(pipe, "unet"), g, r=2)
        for _, leaf in tlora.lora_leaves(tree):
            leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.5
        paths.append(str(tmp_path / f"step_{i}.safetensors"))
        tlora.save_safeloras({"unet": (tree, _targets(pipe, "unet"),
                                       tlora.DEFAULT_TARGET_REPLACE)}, paths[-1])
    imgs = teval.visualize_progress(paths, "a photo of sks", dirs["model"], device="cpu",
                                    num_inference_steps=2, patch_text=False, patch_ti=False)
    arrs = [np.asarray(im) for im in imgs]
    assert len(arrs) == 2 and arrs[0].shape == (16, 16, 3)
    assert not np.array_equal(arrs[0], arrs[1])
    with pytest.raises(ValueError, match="no checkpoints"):
        teval.visualize_progress(str(tmp_path / "none_*.pt"), "x", dirs["model"], device="cpu")


def test_pti_logs_clip_alignment_at_inversion_saves(dirs, tmp_path, monkeypatch, small_images):
    """``log_wandb``: the loss and, with the CLIP set prepared once, the
    alignment of ``evaluate_pipe`` at each inversion save (JAX :303-310,
    :404-430); without the CLIP models, the loss alone."""
    from diffusion_finetuning_tpu_torch import cli_lora_pti

    logged = []
    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(
        init=lambda **kw: None, log=logged.append))
    prepared = []
    monkeypatch.setattr(teval, "prepare_clip_model_sets",
                        lambda *a: prepared.append(1) or _stub_clip())
    kw = dict(instance_data_dir=dirs["inst"], pretrained_model_name_or_path=dirs["model"],
              placeholder_tokens="<s1>", initializer_tokens="photo", resolution=16,
              max_train_steps_ti=2, max_train_steps_tuning=1, save_steps=1,
              gradient_accumulation_steps=1, lora_rank=2, mixed_precision="no",
              color_jitter=False, use_template="object", log_wandb=True,
              wandb_log_prompt_cnt=1, device="cpu")
    cli_lora_pti.train(output_dir=str(tmp_path / "a"), **kw)
    assert prepared == [1]
    assert [sorted(d) for d in logged] == [["loss"], [
        "image_alignment_all", "image_alignment_avg", "text_alignment_all",
        "text_alignment_avg"]] * 2

    def absent(*a):
        raise OSError("no CLIP weights offline")

    logged.clear()
    monkeypatch.setattr(teval, "prepare_clip_model_sets", absent)
    cli_lora_pti.train(output_dir=str(tmp_path / "b"), **kw)
    assert [sorted(d) for d in logged] == [["loss"]] * 2
