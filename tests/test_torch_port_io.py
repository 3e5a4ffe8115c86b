"""The port's LoRA and TI files against the JAX package's, on the CPU.

Safetensors written by the port must be byte-identical to the JAX writer's
for the same tensors and metadata (fp32, fp16 and bf16), and each package
reads the other's safetensors and ``.pt`` files (the JAX side through its
own pickle codec) with equal values: no tolerance, the bytes are the same.
The LoRA functions built on them (``save_all`` in both forms, the
conversions, ``parse_safeloras``, the monkeypatch family, ``inspect_lora``,
``weight_apply_lora``, TI table growth) are held against the JAX ones on
the same numpy inputs: exactly where both do the same fp32 arithmetic,
within 1e-6 (``inspect_lora``, the merges: sums in another order).
"""

import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu import lora as jlora
from diffusion_finetuning_tpu.data.tokenizer import CLIPTokenizer as JTok
from diffusion_finetuning_tpu.io import safetensors_io as jst
from diffusion_finetuning_tpu.io import torch_pickle
from diffusion_finetuning_tpu.models import clip_text as jclip
from diffusion_finetuning_tpu.models import unet as junet
from diffusion_finetuning_tpu.pipelines import pipeline as jpipeline

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from diffusion_finetuning_tpu_torch.io import safetensors_io as tst
from diffusion_finetuning_tpu_torch.models import clip_text as tclip
from diffusion_finetuning_tpu_torch.models import weights
from diffusion_finetuning_tpu_torch.pipelines import pipeline as tpipeline

from tests.torch_port_fixtures import numpy_lora_tree, tiny_params, to_jax

UCFG, TCFG = junet.UNetConfig.tiny(), jclip.CLIPTextConfig.tiny()


def _targets():
    unet = jlora.filter_targets(junet.unet_all_lora_targets(UCFG),
                                jlora.UNET_EXTENDED_TARGET_REPLACE)
    text = jclip.text_encoder_lora_targets(TCFG)
    return unet, text


def _trees(seed=0):
    unet, text = _targets()
    return (numpy_lora_tree(unet, rank=2, seed=seed),
            numpy_lora_tree(text, rank=3, seed=seed + 1))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _np(t):
    t = torch.as_tensor(t)
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_trees_equal(jax_tree, torch_tree):
    jl = dict(jlora_leaves(jax_tree))
    tl = dict(tlora.lora_leaves(torch_tree))
    assert jl.keys() == tl.keys()
    for path, leaf in jl.items():
        for k in ("up", "down", "scale"):
            np.testing.assert_array_equal(np.asarray(leaf[k], np.float32),
                                          _np(tl[path][k]).astype(np.float32))


def jlora_leaves(tree, prefix=()):
    for k, v in tree.items():
        if "up" in v and not isinstance(v["up"], dict):
            yield prefix + (k,), v
        else:
            yield from jlora_leaves(v, prefix + (k,))


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_safetensors_byte_identical_and_cross_readable(tmp_path, dtype):
    rng = np.random.default_rng(0)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    arrays = {"w": rng.standard_normal((5, 3)).astype(np_dtype),
              "b": rng.standard_normal((3,)).astype(np_dtype),
              "s": np.asarray(0.5, np_dtype), "empty": np.zeros((0, 4), np_dtype),
              "ids": np.arange(6, dtype=np.int64).reshape(2, 3)}
    meta = {"z": "last", "a": "first", "<s1>": "<embed>"}
    tensors = {k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
               if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(np.array(v))
               for k, v in arrays.items()}
    jst.write_safetensors(arrays, str(tmp_path / "jax.safetensors"), meta)
    tst.write_safetensors(tensors, str(tmp_path / "port.safetensors"), meta)
    assert _bytes(tmp_path / "jax.safetensors") == _bytes(tmp_path / "port.safetensors")

    got, got_meta = tst.read_safetensors(str(tmp_path / "jax.safetensors"))
    assert got_meta == meta
    want, _ = jst.read_safetensors(str(tmp_path / "port.safetensors"))
    for k, a in arrays.items():
        assert got[k].dtype == tensors[k].dtype
        np.testing.assert_array_equal(_np(got[k]).reshape(np.shape(a)),
                                      np.asarray(a, np.float64))
        np.testing.assert_array_equal(np.asarray(want[k], np.float64).reshape(np.shape(a)),
                                      np.asarray(a, np.float64))


def test_pt_files_cross_both_ways(tmp_path):
    """A LoRA list and a TI dict written by each package's saver are read by
    the other's reader with equal values (fp16 lists, fp32 embeds)."""
    unet_np, _ = _trees(3)
    unet_t, _ = _targets()
    jlora.save_lora_weight(to_jax(unet_np), unet_t, str(tmp_path / "jax.pt"))
    tlora.save_lora_weight(weights.lora_tree_to_torch(unet_np), unet_t,
                           str(tmp_path / "port.pt"))
    from_jax = torch.load(str(tmp_path / "jax.pt"), weights_only=True)
    from_port = torch_pickle.load(str(tmp_path / "port.pt"))
    assert len(from_jax) == len(from_port) == 2 * len(unet_t)
    for a, b in zip(from_jax, from_port):
        assert a.dtype == torch.float16 and np.asarray(b).dtype == np.float16
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    emb = {"<s1>": np.random.default_rng(1).standard_normal(32).astype(np.float32)}
    torch_pickle.save(emb, str(tmp_path / "jax.ti.pt"))
    torch.save({k: torch.from_numpy(v) for k, v in emb.items()}, str(tmp_path / "port.ti.pt"))
    np.testing.assert_array_equal(
        torch.load(str(tmp_path / "jax.ti.pt"), weights_only=True)["<s1>"].numpy(), emb["<s1>"])
    np.testing.assert_array_equal(
        np.asarray(torch_pickle.load(str(tmp_path / "port.ti.pt"))["<s1>"]), emb["<s1>"])


def test_save_all_safetensors_byte_identical(tmp_path):
    """save_all's consolidated form with UNet (conv targets too) and text
    LoRAs and a TI embed: the same bytes from both packages; parse_safeloras
    reads back JAX's ranks and targets."""
    (unet_np, text_np), (ut, tt) = _trees(5), _targets()
    emb = {"<s1>": np.linspace(-1, 1, 32, dtype=np.float32)}
    kw = dict(target_replace_module_unet=jlora.UNET_EXTENDED_TARGET_REPLACE)
    jlora.save_all(to_jax(unet_np), to_jax(text_np), ut, tt, emb,
                   str(tmp_path / "jax.safetensors"), **kw)
    tlora.save_all(weights.lora_tree_to_torch(unet_np), weights.lora_tree_to_torch(text_np),
                   ut, tt, {k: torch.from_numpy(v) for k, v in emb.items()},
                   str(tmp_path / "port.safetensors"), **kw)
    assert _bytes(tmp_path / "jax.safetensors") == _bytes(tmp_path / "port.safetensors")

    want = jlora.load_safeloras(str(tmp_path / "jax.safetensors"))
    got, embeds = tlora.load_safeloras_both(str(tmp_path / "jax.safetensors"))
    assert got.keys() == want.keys() == {"unet", "text_encoder"}
    for name in want:
        assert got[name][1] == want[name][1] and got[name][2] == want[name][2]
        for a, b in zip(got[name][0], want[name][0]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(embeds["<s1>"].numpy(), emb["<s1>"])
    assert set(got["unet"][1]) == {2} and set(got["text_encoder"][1]) == {3}


def test_save_all_pt_triple_and_conversion(tmp_path):
    """The ``.pt`` triple of each package holds equal values; converting
    either triple with convert_loras_to_safeloras_with_embeds gives the
    same bytes from both packages."""
    (unet_np, text_np), (ut, tt) = _trees(7), _targets()
    ut = jlora.filter_targets(ut, jlora.DEFAULT_TARGET_REPLACE)
    emb = {"<tok>": np.random.default_rng(2).standard_normal(32).astype(np.float32)}
    jlora.save_all(to_jax(unet_np), to_jax(text_np), ut, tt, emb, str(tmp_path / "jax.pt"),
                   safe_form=False)
    tlora.save_all(weights.lora_tree_to_torch(unet_np), weights.lora_tree_to_torch(text_np),
                   ut, tt, emb, str(tmp_path / "port.pt"), safe_form=False)
    for suffix in (".pt", ".text_encoder.pt"):
        a = torch.load(str(tmp_path / ("jax" + suffix)), weights_only=True)
        b = torch.load(str(tmp_path / ("port" + suffix)), weights_only=True)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == torch.float16
            assert torch.equal(x, y)
    ti = torch.load(str(tmp_path / "port.ti.pt"), weights_only=True)
    np.testing.assert_array_equal(ti["<tok>"].numpy(), emb["<tok>"])

    for who in ("jax", "port"):
        modelmap = {"unet": (str(tmp_path / f"{who}.pt"), jlora.DEFAULT_TARGET_REPLACE, 2),
                    "text_encoder": (str(tmp_path / f"{who}.text_encoder.pt"),
                                     jlora.TEXT_ENCODER_DEFAULT_TARGET_REPLACE, 3)}
        jlora.convert_loras_to_safeloras_with_embeds(
            modelmap, str(tmp_path / f"{who}.ti.pt"), str(tmp_path / f"{who}_j.safetensors"))
        tlora.convert_loras_to_safeloras_with_embeds(
            modelmap, str(tmp_path / f"{who}.ti.pt"), str(tmp_path / f"{who}_t.safetensors"))
        assert _bytes(tmp_path / f"{who}_j.safetensors") == _bytes(
            tmp_path / f"{who}_t.safetensors")
    tlora.convert_loras_to_safeloras({"unet": modelmap["unet"]},
                                     str(tmp_path / "unet_only.safetensors"))
    assert tlora.load_safeloras(str(tmp_path / "unet_only.safetensors")).keys() == {"unet"}


def test_flat_tree_roundtrip_and_monkeypatch_family(tmp_path):
    """lora_tree_to_flat / flat_to_lora_tree (conv pairs also as 2-D rank
    factors), monkeypatch_lora, _or_replace (rank lists checked),
    _or_replace_safeloras, _add and _remove give JAX's trees."""
    (unet_np, _), (ut, _) = _trees(9), _targets()
    flat = tlora.lora_tree_to_flat(weights.lora_tree_to_torch(unet_np), ut)
    jflat = jlora.lora_tree_to_flat(to_jax(unet_np), ut)
    for a, b in zip(flat, jflat):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    squeezed = [f.reshape(f.shape[0], -1) if f.ndim == 4 else f for f in flat]
    back = tlora.flat_to_lora_tree(squeezed, ut, scale=0.5, dtype=torch.bfloat16)
    _assert_trees_equal(jlora.flat_to_lora_tree([np.asarray(f) for f in squeezed], ut,
                                                scale=0.5, dtype=jax.numpy.bfloat16), back)
    with pytest.raises(ValueError, match="does not match"):
        tlora.flat_to_lora_tree(flat[2:] + flat[:2], ut)

    tlora.save_lora_weight(weights.lora_tree_to_torch(unet_np), ut, str(tmp_path / "u.pt"))
    _assert_trees_equal(jlora.monkeypatch_lora(str(tmp_path / "u.pt"), ut),
                        tlora.monkeypatch_lora(str(tmp_path / "u.pt"), ut))
    _assert_trees_equal(jlora.monkeypatch_replace_lora(str(tmp_path / "u.pt"), ut),
                        tlora.monkeypatch_or_replace_lora(str(tmp_path / "u.pt"), ut,
                                                          r=[2] * len(ut)))
    with pytest.raises(ValueError, match="rank list"):
        tlora.monkeypatch_or_replace_lora(str(tmp_path / "u.pt"), ut, r=[2])
    new = [np.asarray(f) * 0.5 for f in jflat]
    _assert_trees_equal(
        jlora.monkeypatch_add_lora(to_jax(unet_np), new, ut, alpha=0.3, beta=0.9),
        tlora.monkeypatch_add_lora(weights.lora_tree_to_torch(unet_np), new, ut, alpha=0.3,
                                   beta=0.9))
    assert tlora.monkeypatch_remove_lora(unet_np) == {}

    class Models:
        unet_lora = None

        def lora_targets(self, name, replace):
            if name != "unet":
                raise KeyError(name)
            return jlora.filter_targets(ut, replace)

    path = str(tmp_path / "s.safetensors")
    jlora.save_all(to_jax(unet_np), to_jax(_trees(9)[1]), ut, _targets()[1], None, path,
                   target_replace_module_unet=jlora.UNET_EXTENDED_TARGET_REPLACE)
    models = Models()
    out = tlora.monkeypatch_or_replace_safeloras(models, tst.read_safetensors(path))
    want = jlora.monkeypatch_or_replace_safeloras(Models(), jst.read_safetensors(path))
    assert out.keys() == want.keys() == {"unet"} and models.unet_lora is out["unet"]
    _assert_trees_equal(want["unet"], out["unet"])


def test_inspect_and_weight_apply_lora_match_jax(tmp_path):
    """inspect_lora's mean |up @ down| per module and weight_apply_lora's
    merged weights (UNet with conv targets, through the weight bridge; the
    text encoder under its prefix) against JAX, within 1e-6."""
    (unet_np, text_np), (ut, tt) = _trees(11), _targets()
    got = tlora.inspect_lora(weights.lora_tree_to_torch(unet_np))
    want = jlora.inspect_lora(to_jax(unet_np))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)

    unet_p, _, text_p = tiny_params()
    flat = jlora.lora_tree_to_flat(unet_np, ut)
    want_sd = weights.unet_state_dict(
        jax.tree_util.tree_map(np.asarray, jlora.weight_apply_lora(to_jax(unet_p), flat, ut,
                                                                   alpha=0.8)), UCFG)
    base = weights.to_torch(weights.unet_state_dict(unet_p, UCFG))
    got_sd = tlora.weight_apply_lora(base, [torch.from_numpy(f) for f in flat], ut, alpha=0.8)
    changed = 0
    for k, w in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), w, atol=1e-6, rtol=1e-6)
        changed += not torch.equal(got_sd[k], base[k])
    assert changed == len(ut)

    tflat = jlora.lora_tree_to_flat(text_np, tt)
    want_t = weights.text_state_dict(jax.tree_util.tree_map(
        np.asarray, jlora.weight_apply_lora(to_jax(text_p), tflat, tt)), TCFG)
    got_t = tlora.weight_apply_lora(weights.to_torch(weights.text_state_dict(text_p, TCFG)),
                                    tflat, tt, prefix=tclip.CLIPTextModel.lora_prefix)
    for k, w in want_t.items():
        np.testing.assert_allclose(got_t[k].numpy(), w, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        tlora.weight_apply_lora(base, flat[:-2], ut)


def test_token_table_growth_and_ti_rows_match_jax():
    """resize_token_embeddings (zeros, or N(0, 0.02) from a generator) and
    apply_learned_embed_in_clip with the collision-rename loop: the same
    token names and the same table as JAX, the input table untouched."""
    jtok, ttok = JTok.tiny(["photo"]), TTok.tiny(["photo"])
    base = len(ttok)  # a table sized to the vocabulary: every new token grows it
    table = np.random.default_rng(4).standard_normal((base, 32)).astype(np.float32)
    jparams = {"token_embedding": {"embedding": jax.numpy.asarray(table)}}
    tparams = {tclip.TOKEN_EMBEDDING: torch.from_numpy(table.copy())}

    grown = tclip.resize_token_embeddings(tparams, base + 8)
    want = np.asarray(jclip.resize_token_embeddings(jparams, base + 8)["token_embedding"]["embedding"])
    np.testing.assert_array_equal(grown[tclip.TOKEN_EMBEDDING].numpy(), want)
    assert tclip.resize_token_embeddings(tparams, base - 1) is tparams
    drawn = tclip.resize_token_embeddings(tparams, base + 4000, torch.Generator().manual_seed(0))
    rows = drawn[tclip.TOKEN_EMBEDDING][base:]
    assert rows.shape == (4000, 32) and abs(float(rows.std()) - 0.02) < 1e-3

    embeds = {"<cat>": np.full(32, 0.25, np.float32), "<dog>": np.full(32, -0.5, np.float32)}
    for tok in (jtok, ttok):
        tok.add_tokens("<cat>")  # a collision: renamed to <cat-1> when not idempotent
    jp, jnames = jpipeline.apply_learned_embed_in_clip(embeds, jparams, jtok)
    tp, tnames = tpipeline.apply_learned_embed_in_clip(embeds, tparams, ttok)
    assert tnames == jnames == ["<cat-1>", "<dog>"] and len(ttok) == len(jtok) == base + 3
    np.testing.assert_array_equal(tp[tclip.TOKEN_EMBEDDING].numpy(),
                                  np.asarray(jp["token_embedding"]["embedding"]))
    np.testing.assert_array_equal(tparams[tclip.TOKEN_EMBEDDING].numpy(), table)
    # idempotent: the existing row is replaced, nothing grows
    tp2, name = tpipeline.apply_learned_embed_in_clip({"<dog>": np.ones(32, np.float32)}, tp,
                                                      ttok, idempotent=True)
    assert name == "<dog>" and tp2[tclip.TOKEN_EMBEDDING].shape[0] == base + 3
    assert float(tp2[tclip.TOKEN_EMBEDDING][ttok.convert_tokens_to_ids("<dog>")].min()) == 1.0
    assert float(tp[tclip.TOKEN_EMBEDDING][ttok.convert_tokens_to_ids("<dog>")].max()) == -0.5


def test_sidecar_paths_and_save_guards(tmp_path):
    assert tlora._text_lora_path("a/b.c.pt") == jlora._text_lora_path("a/b.c.pt")
    assert tlora._ti_lora_path("x.pt") == jlora._ti_lora_path("x.pt") == "x.ti.pt"
    with pytest.raises(ValueError):
        tlora._ti_lora_path("x.safetensors")
    with pytest.raises(ValueError, match="safetensors"):
        tlora.save_all({}, None, [], [], None, str(tmp_path / "x.bin"))
    with pytest.raises(ValueError, match="No lora injected"):
        tlora.extract_lora_ups_down({}, _targets()[0])
    (unet_np, _), (ut, _) = _trees(1), _targets()
    tlora.save_lora_as_json(weights.lora_tree_to_torch(unet_np), ut, str(tmp_path / "j.json"))
    jlora.save_lora_as_json(to_jax(unet_np), ut, str(tmp_path / "k.json"))
    assert _bytes(tmp_path / "j.json") == _bytes(tmp_path / "k.json")
    assert os.path.getsize(tmp_path / "j.json") > 0
