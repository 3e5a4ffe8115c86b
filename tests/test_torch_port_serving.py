"""The port's serving entry point against the JAX package's, on the CPU.

* Model directories cross both ways: the port's ``from_pretrained`` on a
  directory JAX's ``hf_export.save_pretrained`` wrote gives JAX's images,
  and JAX's ``from_pretrained`` reads the port's ``save_pretrained`` output
  back to JAX's parameters exactly (fp32 written and read, no arithmetic).
* ``patch_pipe`` with a JAX-written safetensors file (UNet and text LoRA, a
  TI token) and with a JAX-written ``.pt`` triple, and ``build_adapter`` +
  ``adapter_params``, give JAX's token ids and JAX's images.
* The JAX server tests without a mesh (``tests/test_serving.py``) run
  against the port's ``GenerationServer``, and one HTTP request goes to
  ``serve`` over loopback.

Images: uint8 within 1/255, as in ``test_torch_port_pipeline.py`` (the
same fp32 value may round to neighbouring levels on the two sides; the
dynamic LoRA against JAX's merged one adds rounding of the same size).
Server images against their lone runs: one uint8 level (a request
coalesced into a batch of 2 or 4 runs the CPU's matmuls in another order
than alone), and two adapters must differ by more than that.
"""

import io
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_finetuning_tpu import lora as jlora
from diffusion_finetuning_tpu.models import hf_export as jexport
from diffusion_finetuning_tpu.pipelines import pipeline as jpipeline

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.models import clip_text as tclip
from diffusion_finetuning_tpu_torch.models import hf_export as texport
from diffusion_finetuning_tpu_torch.models import hf_loading
from diffusion_finetuning_tpu_torch.pipelines import pipeline as tpipeline
from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline
from diffusion_finetuning_tpu_torch.serving import GenerationServer

from tests.test_torch_port_pipeline import _port_pipe
from tests.torch_port_fixtures import numpy_lora_tree, tiny_params, to_jax, to_numpy

KW = dict(height=16, width=16, num_inference_steps=3, guidance_scale=7.5, output_type="np")


def _latents(b=1):
    return np.random.default_rng(2).standard_normal((b, 8, 8, 4)).astype(np.float32)


def _close(a, b):
    assert a.shape == b.shape
    assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1.0 / 255 + 1e-6


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A JAX pipeline of the tiny weights and the directory its
    save_pretrained wrote (weights, configs, tokenizer)."""
    from tests.test_torch_port_pipeline import WORDS
    from diffusion_finetuning_tpu.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu.models.clip_text import CLIPTextConfig
    from diffusion_finetuning_tpu.models.schedulers import SchedulerConfig
    from diffusion_finetuning_tpu.models.unet import UNetConfig
    from diffusion_finetuning_tpu.models.vae import VAEConfig

    unet_p, vae_p, text_p = tiny_params()
    jpipe = jpipeline.StableDiffusionPipeline(
        UNetConfig.tiny(), to_jax(unet_p), VAEConfig.tiny(), to_jax(vae_p),
        CLIPTextConfig.tiny(), to_jax(text_p), CLIPTokenizer.tiny(WORDS), SchedulerConfig())
    d = str(tmp_path_factory.mktemp("jax_sd"))
    jexport.save_pretrained(jpipe, d)
    return jpipe, d


def _lora_files(tmp_path, pipe, seed):
    """A JAX-written consolidated file (UNet + text LoRA + TI token <s1>)
    and a JAX-written ``.pt`` triple (TI token <p1>)."""
    ut = pipe.lora_targets("unet", jlora.DEFAULT_TARGET_REPLACE)
    tt = pipe.lora_targets("text_encoder", jlora.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
    unet = to_jax(numpy_lora_tree(ut, rank=2, seed=seed, amp=0.5))
    text = to_jax(numpy_lora_tree(tt, rank=2, seed=seed + 1, amp=0.5))
    rng = np.random.default_rng(seed)
    safe = str(tmp_path / f"a{seed}.safetensors")
    jlora.save_all(unet, text, ut, tt, {"<s1>": rng.standard_normal(32).astype(np.float32)},
                   safe)
    pt = str(tmp_path / f"b{seed}.pt")
    jlora.save_all(unet, text, ut, tt, {"<p1>": rng.standard_normal(32).astype(np.float32)},
                   pt, safe_form=False)
    return safe, pt


def test_from_pretrained_reads_a_jax_directory(jax_dir):
    jpipe, d = jax_dir
    pipe = StableDiffusionPipeline.from_pretrained(d, device="cpu")
    assert pipe.unet_config == hf_loading.unet_config_from_hf(
        hf_loading.read_json(os.path.join(d, "unet", "config.json")))
    assert pipe.scheduler_config == tpipeline.SchedulerConfig()
    prompts = ["a photo of sks", "photo"]
    want = jpipe(prompts, latents=jnp.asarray(_latents(2)), **KW)
    _close(pipe(prompts, latents=_latents(2), **KW), want)


def test_jax_reads_the_port_save_pretrained(tmp_path):
    """The port's export (fp32, and bf16 read back to the same bf16
    values) loads into JAX's from_pretrained with JAX's parameters."""
    pipe = _port_pipe()
    texport.save_pretrained(pipe, str(tmp_path / "fp32"))
    back = jpipeline.StableDiffusionPipeline.from_pretrained(str(tmp_path / "fp32"))
    for got, want in zip((back.unet_params, back.vae_params, back.text_params), tiny_params()):
        for a, b in zip(jax.tree_util.tree_leaves(to_numpy(got)), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    assert len(back.tokenizer) == len(pipe.tokenizer)

    texport.save_pretrained(pipe, str(tmp_path / "bf16"), dtype=torch.bfloat16)
    half = StableDiffusionPipeline.from_pretrained(str(tmp_path / "bf16"), dtype=torch.bfloat16,
                                                   device="cpu")
    for name, w in pipe.unet.state_dict().items():
        assert torch.equal(half.unet.state_dict()[name], w.to(torch.bfloat16))
    assert half.dtype == torch.bfloat16


def test_vae_and_text_spellings_are_read():
    """The newer VAE attention names (and 1x1 conv weights) and a text
    encoder without its prefix map onto the port's names; extra buffers
    are dropped."""
    sd = {"decoder.mid_block.attentions.0.to_q.weight": torch.ones(4, 4, 1, 1),
          "decoder.mid_block.attentions.0.to_out.0.bias": torch.ones(4),
          "encoder.conv_in.weight": torch.ones(2)}
    out = hf_loading.vae_state_dict_from_hf(sd)
    assert out["decoder.mid_block.attentions.0.query.weight"].shape == (4, 4)
    assert "decoder.mid_block.attentions.0.proj_attn.bias" in out
    text = hf_loading.text_state_dict_from_hf({"embeddings.position_ids": torch.zeros(1)})
    assert list(text) == ["text_model.embeddings.position_ids"]
    kept = hf_loading.module_state_dict(tclip.CLIPTextModel, tclip.CLIPTextConfig.tiny(),
                                        dict(text, x=torch.zeros(1)))
    assert kept == {}


@pytest.mark.parametrize("form", ["safetensors", "pt"])
def test_patch_pipe_matches_jax(jax_dir, tmp_path, form):
    """patch_pipe with UNet, text and TI from JAX-written files: the TI
    token gets the id JAX gives it, the token table its row, and the
    images agree with JAX's."""
    jpipe0, d = jax_dir
    jpipe = jpipeline.StableDiffusionPipeline.from_pretrained(d)
    pipe = StableDiffusionPipeline.from_pretrained(d, device="cpu")
    safe, pt = _lora_files(tmp_path, pipe, seed=3)
    path, token = (safe, "<s1>") if form == "safetensors" else (pt, "<p1>")
    kw = dict(patch_unet=True, patch_text=True, patch_ti=True)
    jpipeline.patch_pipe(jpipe, path, **kw)
    tpipeline.patch_pipe(pipe, path, **kw)
    prompt = [f"a photo of {token}"]
    ids = pipe.tokenizer(prompt, padding="max_length", max_length=77,
                         return_tensors="np")["input_ids"]
    np.testing.assert_array_equal(ids, jpipe.tokenizer(prompt, padding="max_length",
                                                       max_length=77,
                                                       return_tensors="np")["input_ids"])
    tid = pipe.tokenizer.convert_tokens_to_ids(token)
    np.testing.assert_array_equal(
        pipe.text_params[tclip.TOKEN_EMBEDDING][tid].numpy(),
        np.asarray(jpipe.text_params["token_embedding"]["embedding"][tid]))
    want = jpipe(prompt, latents=jnp.asarray(_latents()), **KW)
    got = pipe(prompt, latents=_latents(), **KW)
    _close(got, want)
    base = jpipe0(prompt[0].replace(token, "sks"), latents=jnp.asarray(_latents()), **KW)
    assert np.abs(got - base).max() > 2.0 / 255  # the LoRA and the token are on the path


def test_build_adapter_params_match_jax_and_leave_the_pipe(jax_dir, tmp_path):
    """An adapter built from a JAX-written file and passed per request
    (served dynamic here, merged on the JAX side) gives JAX's image, and
    installs nothing; a token added after a tree set was built is refused
    for that set."""
    jpipe0, d = jax_dir
    jpipe = jpipeline.StableDiffusionPipeline.from_pretrained(d)
    pipe = StableDiffusionPipeline.from_pretrained(d, device="cpu")
    safe, pt = _lora_files(tmp_path, pipe, seed=5)
    jad = jpipeline.build_adapter(jpipe, safe)
    tad = tpipeline.build_adapter(pipe, safe)
    assert set(tad) == set(jad) == {"unet_lora", "text_encoder_lora", "text_params"}
    assert pipe.unet_lora is None and pipe.text_params == {}
    jparams = jpipe.adapter_generation_params(jad["unet_lora"], jad["text_encoder_lora"],
                                              jad["text_params"])
    tparams = pipe.adapter_generation_params(tad["unet_lora"], tad["text_encoder_lora"],
                                             tad["text_params"], materialize=False)
    assert tparams[1] is not None and tparams[0] == {}
    prompt = ["<s1> photo"]
    want = jpipe(prompt, latents=jnp.asarray(_latents()), adapter_params=jparams, **KW)
    _close(pipe(prompt, latents=_latents(), adapter_params=tparams, **KW), want)

    # a table sized to the vocabulary: a later token is outside it
    small = {tclip.TOKEN_EMBEDDING: pipe.text_encoder.state_dict()[tclip.TOKEN_EMBEDDING][
        :len(pipe.tokenizer)]}
    pipe.tokenizer.add_tokens("<late>")
    with pytest.raises(ValueError, match="rows"):
        pipe(["<late>"], adapter_params=pipe.adapter_generation_params(text_params=small), **KW)


def test_merged_lru_and_installed_slot():
    """Explicit adapters' merged sets are kept in an LRU of
    MERGED_LORA_CACHE_SIZE found again by tree identity; the installed
    tree has one slot, replaced on a swap."""
    pipe = _port_pipe()
    targets = pipe.lora_targets("unet", tlora.DEFAULT_TARGET_REPLACE)
    trees = [tlora.flat_to_lora_tree(jlora.lora_tree_to_flat(
        numpy_lora_tree(targets, seed=s), targets), targets) for s in range(3)]
    old = tpipeline.MERGED_LORA_CACHE_SIZE
    tpipeline.MERGED_LORA_CACHE_SIZE = 2
    try:
        first = pipe.adapter_generation_params(trees[0])[0]
        assert pipe.adapter_generation_params(trees[0])[0] is first
        pipe.adapter_generation_params(trees[1])
        pipe.adapter_generation_params(trees[2])
        assert len(pipe._merged_cache) == 2
        assert pipe.adapter_generation_params(trees[0])[0] is not first  # evicted
    finally:
        tpipeline.MERGED_LORA_CACHE_SIZE = old
    pipe.unet_lora = trees[1]
    a = pipe._generation_params()[0]
    pipe.unet_lora = tlora.tune_lora_scale(trees[1], 0.5)
    b = pipe._generation_params()[0]
    assert a is not b and len(pipe._merged_current) == 1


def test_cast_params_casts_weights_trees_and_overrides(tmp_path):
    """cast_params: the modules, the text overrides and the installed trees
    (scales kept fp32) in the new dtype, the merged sets dropped; the pipe
    still generates, and from_pretrained's params_dtype does the same."""
    pipe = _port_pipe()
    targets = pipe.lora_targets("unet", tlora.DEFAULT_TARGET_REPLACE)
    pipe.unet_lora = tlora.flat_to_lora_tree(jlora.lora_tree_to_flat(
        numpy_lora_tree(targets, seed=4), targets), targets)
    pipe.text_params = {tclip.TOKEN_EMBEDDING: pipe.text_encoder.state_dict()[
        tclip.TOKEN_EMBEDDING].clone()}
    pipe._generation_params()
    assert pipe.cast_params(torch.bfloat16) is pipe and pipe._merged_current == {}
    assert pipe.dtype == torch.bfloat16
    assert {p.dtype for m in (pipe.unet, pipe.vae, pipe.text_encoder)
            for p in m.parameters()} == {torch.bfloat16}
    assert pipe.text_params[tclip.TOKEN_EMBEDDING].dtype == torch.bfloat16
    leaves = list(tlora.lora_leaves(pipe.unet_lora))
    assert {leaf["up"].dtype for _, leaf in leaves} == {torch.bfloat16}
    assert {leaf["scale"].dtype for _, leaf in leaves} == {torch.float32}
    assert pipe("photo", height=16, width=16, num_inference_steps=2,
                output_type="uint8").shape == (1, 16, 16, 3)
    texport.save_pretrained(pipe, str(tmp_path / "d"))
    back = StableDiffusionPipeline.from_pretrained(str(tmp_path / "d"), device="cpu",
                                                   params_dtype=torch.bfloat16)
    assert back.dtype == torch.bfloat16
    assert next(back.unet.parameters()).dtype == torch.bfloat16


def test_param_buffers_copy_what_changed():
    """graph.ParamBuffers (the request graphs' LoRA-dependent weights):
    a source that is still the one held copies nothing; a new tensor, an
    in-place edit (its version) and forget() copy; a refilled 3x3 conv
    weight's cached tap-major copy is rewritten in place, the same tensor a
    graph would read."""
    from diffusion_finetuning_tpu_torch.graph import ParamBuffers
    from diffusion_finetuning_tpu_torch.ops import conv3x3

    a, w = torch.randn(4, 3), torch.randn(8, 8, 3, 3)
    bufs = ParamBuffers({"a": a, "w": w})
    assert bufs.buffers["a"] is not a and torch.equal(bufs.buffers["a"], a)
    with torch.inference_mode():  # as a request's warm-up makes it
        w9 = conv3x3.tap_major(bufs.buffers["w"])
    assert bufs.fill({"a": a, "w": w}) == 0
    a2 = torch.randn(4, 3)
    assert bufs.fill({"a": a2, "w": w}) == a2.numel() * 4
    assert torch.equal(bufs.buffers["a"], a2)
    with torch.no_grad():
        w.mul_(-2)
    assert bufs.fill({"a": a2, "w": w}) == w.numel() * 4
    assert conv3x3.tap_major(bufs.buffers["w"]) is w9
    assert torch.equal(w9, w.permute(2, 3, 0, 1).reshape(9, 8, 8))
    bufs.forget()
    assert bufs.fill({"a": a2, "w": w}) == (a2.numel() + w.numel()) * 4


# -- the server (tests/test_serving.py without a mesh) -------------------------

SERVE = dict(height=16, width=16, steps=2, scheduler="ddim")


@pytest.fixture(scope="module")
def pipe():
    return _port_pipe()


def _spy(pipe, calls):
    orig = StableDiffusionPipeline.__call__

    def spy(self, prompt, **kw):
        calls.append(len(prompt) if isinstance(prompt, list) else 1)
        return orig(self, prompt, **kw)

    return orig, spy


def test_server_single_and_concurrent(pipe):
    calls = []
    orig, spy = _spy(pipe, calls)
    StableDiffusionPipeline.__call__ = spy
    try:
        server = GenerationServer(pipe, max_batch=4, max_wait_ms=200)
        assert server.generate("a", **SERVE).size == (16, 16)
        futures = [server.submit(p, **SERVE) for p in ("x", "y", "z")]
        assert all(f.result(timeout=120).size == (16, 16) for f in futures)
        assert max(calls) >= 2
        server.close()
    finally:
        StableDiffusionPipeline.__call__ = orig


def test_partial_batch_splits_down_ladder_not_padded(pipe):
    calls = []
    orig, spy = _spy(pipe, calls)
    StableDiffusionPipeline.__call__ = spy
    try:
        server = GenerationServer(pipe, max_batch=4, max_wait_ms=500)
        futs = [server.submit(p, seed=i, **SERVE) for i, p in enumerate("abc")]
        assert all(f.result(timeout=300).size == (16, 16) for f in futs)
        assert calls == [2, 1], calls
        server.close()
    finally:
        StableDiffusionPipeline.__call__ = orig


def test_server_propagates_errors(pipe):
    server = GenerationServer(pipe, max_batch=2, max_wait_ms=10)
    fut = server.submit("a", height=7, width=7, steps=1)  # not a multiple of the VAE's
    with pytest.raises(ValueError):
        fut.result(timeout=120)
    fut = server.submit("a", height=16, width=16, steps=1, scheduler="heun")
    with pytest.raises(ValueError, match="unknown scheduler"):
        fut.result(timeout=120)
    server.close()


def test_server_per_request_seeds_and_schedulers(pipe):
    """Coalesced requests with different seeds differ, the same seed
    repeats; each image (a PIL image, read as uint8) is its lone run's for
    the server's default scheduler ("dpm") and for euler_a."""
    server = GenerationServer(pipe, max_batch=4, max_wait_ms=200)
    for sched in ("dpm", "euler_a"):
        kw = dict(height=16, width=16, steps=3, scheduler=sched)
        f1, f2, f3 = (server.submit("same prompt", seed=s, **kw) for s in (1, 2, 1))
        a, b, c = (np.asarray(f.result(timeout=180)) for f in (f1, f2, f3))
        assert a.dtype == np.uint8 and np.abs(a.astype(int) - b.astype(int)).max() > 0
        np.testing.assert_array_equal(a, c)
        alone = pipe("same prompt", seed=2, height=16, width=16, num_inference_steps=3,
                     scheduler=sched, output_type="uint8")[0]
        assert np.abs(b.astype(int) - alone.astype(int)).max() <= 1
    server.close()


def test_server_close_fails_pending(pipe):
    server = GenerationServer(pipe, max_batch=2, max_wait_ms=10)
    server._stop.set()
    try:
        fut = server.submit("x", height=16, width=16, steps=1)
    except RuntimeError:
        fut = None
    server.close()
    if fut is not None:
        with pytest.raises(Exception):
            fut.result(timeout=5)


def test_cancelled_future_does_not_poison_batch(pipe):
    server = GenerationServer(pipe, max_batch=4, max_wait_ms=300)
    f1 = server.submit("a", **SERVE)
    f2 = server.submit("b", **SERVE)
    f1.cancel()
    assert f2.result(timeout=300).size == (16, 16)
    server.close()


def test_submit_after_close_raises_not_hangs(pipe):
    server = GenerationServer(pipe, max_batch=2, max_wait_ms=5)
    server.close()
    with pytest.raises(RuntimeError):
        server.submit("a", height=16, width=16, steps=1)
    assert not server._thread.is_alive()


def _save_pair(tmp_path, pipe, seed, name):
    ut = pipe.lora_targets("unet", jlora.DEFAULT_TARGET_REPLACE)
    tt = pipe.lora_targets("text_encoder", jlora.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
    p = str(tmp_path / f"{name}.safetensors")
    tlora.save_all(tlora.flat_to_lora_tree(
        jlora.lora_tree_to_flat(numpy_lora_tree(ut, rank=1, seed=seed), ut), ut),
        tlora.flat_to_lora_tree(jlora.lora_tree_to_flat(
            numpy_lora_tree(tt, rank=1, seed=100 + seed), tt), tt), ut, tt, None, p)
    return p


def test_hot_swap_is_atomic(tmp_path):
    """Requests while patch_pipe swaps between two LoRAs: each image is one
    of the two single-snapshot images, never a mix."""
    pipe = _port_pipe()
    paths = [_save_pair(tmp_path, pipe, s, f"lora_{s}") for s in (1, 2)]
    kw = dict(height=16, width=16, num_inference_steps=2, seed=7, output_type="uint8")
    refs = []
    for p in paths:
        tpipeline.patch_pipe(pipe, p, patch_unet=True, patch_text=True)
        refs.append(pipe("a photo", **kw))
    assert not np.array_equal(refs[0], refs[1])
    stop = threading.Event()

    def patcher():
        i = 0
        while not stop.is_set():
            tpipeline.patch_pipe(pipe, paths[i % 2], patch_unet=True, patch_text=True)
            i += 1
            stop.wait(0.005)  # the swap lock is not fair: leave the requests a turn

    t = threading.Thread(target=patcher, daemon=True)
    t.start()
    try:
        for _ in range(12):
            img = pipe("a photo", **kw)
            assert np.array_equal(img, refs[0]) or np.array_equal(img, refs[1])
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()


def test_multi_tenant_adapters_hammer(tmp_path):
    """Three registered adapters from three threads while a patch loop
    churns the pipe's installed LoRA: every image is its adapter's."""
    pipe = _port_pipe()
    names = [f"tenant{s}" for s in (1, 2, 3)]
    trees = {n: tpipeline.build_adapter(pipe, _save_pair(tmp_path, pipe, s, n))
             for s, n in zip((1, 2, 3), names)}
    churn = [_save_pair(tmp_path, pipe, s, f"churn{s}") for s in (8, 9)]
    server = GenerationServer(pipe, max_batch=4, max_wait_ms=30)
    for n in names:
        server.register_adapter(n, trees[n])
    golden = {}
    for n in names:
        ap = pipe.adapter_generation_params(trees[n]["unet_lora"],
                                            trees[n]["text_encoder_lora"])
        for seed in range(3):
            golden[(n, seed)] = pipe("a photo", seed=seed, height=16, width=16,
                                     num_inference_steps=2, adapter_params=ap,
                                     output_type="uint8")[0].astype(int)
    stop = threading.Event()

    def patcher():
        i = 0
        while not stop.is_set():
            tpipeline.patch_pipe(pipe, churn[i % 2], patch_unet=True, patch_text=True)
            i += 1
            stop.wait(0.005)

    t = threading.Thread(target=patcher, daemon=True)
    t.start()
    futs = []
    try:
        def submitter(name):
            for seed in range(3):
                futs.append(((name, seed), server.submit("a photo", seed=seed, adapter=name,
                                                         **SERVE)))

        threads = [threading.Thread(target=submitter, args=(n,)) for n in names]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        for key, fut in futs:
            img = np.asarray(fut.result(timeout=300)).astype(int)
            assert np.abs(img - golden[key]).max() <= 1, key
            others = [np.abs(img - golden[(n, key[1])]).max() for n in names if n != key[0]]
            assert min(others) > 1, key
    finally:
        stop.set()
        t.join(timeout=30)
        server.close()
    assert len(futs) == 9
    with pytest.raises(KeyError):
        server2 = GenerationServer(pipe, max_batch=2, max_wait_ms=5)
        try:
            server2.submit("x", adapter="nope", **SERVE)
        finally:
            server2.close()


def test_adapter_eviction_under_pressure(monkeypatch):
    """Five adapters, an LRU of two: requests keep routing to the right
    adapter and the cache stays bounded (evicted ones merge again)."""
    monkeypatch.setattr(tpipeline, "MERGED_LORA_CACHE_SIZE", 2)
    pipe = _port_pipe()
    targets = pipe.lora_targets("unet", jlora.DEFAULT_TARGET_REPLACE)
    names = [f"tenant{s}" for s in range(5)]
    trees = {n: {"unet_lora": tlora.flat_to_lora_tree(jlora.lora_tree_to_flat(
        numpy_lora_tree(targets, rank=1, seed=10 + i), targets), targets)}
        for i, n in enumerate(names)}
    golden = {}
    for n in names:
        ap = pipe.adapter_generation_params(unet_lora=trees[n]["unet_lora"])
        golden[n] = pipe("a photo", seed=0, height=16, width=16, num_inference_steps=2,
                         adapter_params=ap, output_type="uint8")[0].astype(int)
        assert len(pipe._merged_cache) <= 2
    server = GenerationServer(pipe, max_batch=2, max_wait_ms=10)
    for n in names:
        server.register_adapter(n, trees[n])
    try:
        futs = [(n, server.submit("a photo", seed=0, adapter=n, **SERVE))
                for _ in range(3) for n in names]
        for n, f in futs:
            img = np.asarray(f.result(timeout=300)).astype(int)
            assert np.abs(img - golden[n]).max() <= 1, n
            assert min(np.abs(img - golden[m]).max() for m in names if m != n) > 1, n
    finally:
        server.close()
    assert len(pipe._merged_cache) <= 2


def test_http_generate_over_loopback(tmp_path):
    """serve's handler: an adapter registered by POST /adapters, then one
    POST /generate answered with a PNG of the requested size; a bad route
    is a 404."""
    from PIL import Image

    from diffusion_finetuning_tpu_torch.serve import make_server

    pipe = _port_pipe()
    path = _save_pair(tmp_path, pipe, 4, "http")
    httpd, server = make_server(pipe, port=0, max_batch=2)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(route, body):
        req = urllib.request.Request(url + route, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=120)

    try:
        assert post("/adapters", {"name": "mine", "path": path}).status == 200
        resp = post("/generate", {"prompt": "a photo", "steps": 2, "height": 16, "width": 16,
                                  "scheduler": "ddim", "seed": 3, "adapter": "mine"})
        assert resp.headers["Content-Type"] == "image/png"
        img = Image.open(io.BytesIO(resp.read()))
        assert img.size == (16, 16)
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/nothing", {})
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=30)
    assert not thread.is_alive()
