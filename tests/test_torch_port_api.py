"""The port's public surface against the JAX package's, on the CPU.

* every name of JAX ``lora.__all__`` and of its lazy ``_LAZY`` table
  resolves on ``diffusion_finetuning_tpu_torch``, the lazy ones to the
  port's own modules, and a fresh import loads neither JAX, transformers
  nor wandb;
* ``multi_group_optimizer(param_labels=...)``, as a label tree and as a
  callable, one top-level subtree split over two groups, against
  ``optax.multi_transform`` (JAX's ``multi_group_optimizer``) over three
  steps: parameters within 1e-6 absolute (the same fp32 AdamW, clip and
  schedule; the moments' sums may round differently);
* the five recipes under ``diffusion_finetuning_tpu_torch/training_scripts``
  carry their JAX twins' flags, and each flag goes through the port's
  parser (none is run).
"""

import inspect
import os
import re
import shlex
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_finetuning_tpu as jpkg
from diffusion_finetuning_tpu import lora as jlora
from diffusion_finetuning_tpu.training import optim as jopt

import diffusion_finetuning_tpu_torch as tpkg
from diffusion_finetuning_tpu_torch.training import optim as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ["run_lorpt.sh", "run_lora_db_unet_only.sh", "run_lora_db_w_text.sh",
           "multivector_example.sh", "use_face_conditioning_example.sh"]


@pytest.mark.parametrize("name", sorted(set(jlora.__all__) | set(jpkg._LAZY)))
def test_public_name_resolves_in_the_port(name):
    value = getattr(tpkg, name)
    assert name in dir(tpkg)
    if name in jpkg._LAZY:
        module = getattr(value, "__module__", None) or tpkg._LAZY[name]
        if not isinstance(value, (list, tuple, dict, str)):
            assert module.startswith("diffusion_finetuning_tpu_torch."), module
        assert tpkg._LAZY[name].split(".")[0] in jpkg._LAZY[name][0]
    else:
        assert name in tpkg.__all__


def test_fresh_import_stays_light():
    code = ("import sys, diffusion_finetuning_tpu_torch as d; d.save_all; "
            "print(sorted(m for m in ('jax', 'transformers', 'wandb', "
            "'diffusion_finetuning_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout.strip()
    assert out == "[]"


def _params(rng):
    def pair(r, o, i):
        return {"up": rng.standard_normal((o, r)).astype(np.float32),
                "down": rng.standard_normal((r, i)).astype(np.float32)}

    return {"unet_lora": {"a": pair(2, 6, 5), "b": pair(2, 4, 3)},
            "text_lora": {"c": pair(2, 3, 7)}}


LEAF_LABELS = {"unet_lora": {"a": {"up": "fast", "down": "fast"},
                             "b": {"up": "slow", "down": "slow"}},
               "text_lora": {"c": {"up": "slow", "down": "slow"}}}


@pytest.mark.parametrize("labels", ["tree", "callable"])
def test_param_labels_match_optax_multi_transform(labels):
    rng = np.random.default_rng(0)
    params = _params(rng)
    grads = [jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                    params) for _ in range(3)]
    kw = dict(max_grad_norm=2.0)
    groups = {"fast": dict(lr=1e-2, schedule="linear", total_steps=5, weight_decay=0.1),
              "slow": dict(lr=1e-3, weight_decay=0.0)}
    tx = jopt.multi_group_optimizer({k: jopt.ParamGroup(**v) for k, v in groups.items()},
                                    param_labels=LEAF_LABELS, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)

    tparams = jax.tree_util.tree_map(lambda a: torch.tensor(a, requires_grad=True), params)
    # the callable labels inner nodes: a whole subtree takes one group
    port_labels = (LEAF_LABELS if labels == "tree" else
                   lambda p: {"unet_lora": {"a": "fast", "b": "slow"}, "text_lora": "slow"})
    opt = topt.multi_group_optimizer({k: topt.ParamGroup(**v) for k, v in groups.items()},
                                     param_labels=port_labels, **kw)
    ost = opt.init(tparams)
    assert sorted(ost.groups) == ["fast", "slow"] and len(ost.groups["fast"]) == 2
    leaves = list(topt.trainable_tensors(tparams))
    for g in grads:
        for t, gv in zip(leaves, jax.tree_util.tree_leaves(
                {k: g[k] for k in sorted(g)})):
            t.grad = torch.from_numpy(np.asarray(gv))
        opt.step(ost)
    want = jax.tree_util.tree_leaves({k: jp[k] for k in sorted(jp)})
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_param_labels_default_and_unknown_group():
    params = {"unet_lora": {"w": torch.zeros(3, requires_grad=True)}}
    opt = topt.multi_group_optimizer({"unet_lora": topt.ParamGroup(lr=1e-3)})
    assert list(opt.init(params).groups) == ["unet_lora"]
    bad = topt.multi_group_optimizer({"unet_lora": topt.ParamGroup(lr=1e-3)},
                                     param_labels={"unet_lora": "other"})
    with pytest.raises(ValueError, match="no ParamGroup"):
        bad.init(params)


def _recipe(path):
    """(command words, {flag: value or True}) of a recipe, its exported
    variables substituted."""
    text = open(path).read().replace("\\\n", " ")
    env = dict(re.findall(r'^export (\w+)="([^"]*)"', text, re.M))
    lines = [ln for ln in text.splitlines()
             if ln.strip() and not ln.startswith(("#", "export"))]
    assert len(lines) == 1, lines
    words = shlex.split(re.sub(r"\$(\w+)", lambda m: env[m.group(1)], lines[0]))
    cmd = [w for w in words if not w.startswith("--")]
    flags = {}
    for w in words:
        if w.startswith("--"):
            k, _, v = w[2:].partition("=")
            flags[k] = v if _ else True
    return cmd, flags, [w for w in words if w.startswith("--")]


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_flags_go_through_the_port_parser(name):
    cmd, flags, argv = _recipe(os.path.join(REPO, "diffusion_finetuning_tpu_torch",
                                            "training_scripts", name))
    _, jflags, _ = _recipe(os.path.join(REPO, "training_scripts", name))
    assert flags == jflags  # the same flags as the JAX twin
    if cmd == ["lora_pti_torch"]:
        from diffusion_finetuning_tpu_torch import cli_lora_pti
        from diffusion_finetuning_tpu_torch.utils.cli import Fire

        with open(os.path.join(REPO, "setup.py")) as f:
            assert "lora_pti_torch = diffusion_finetuning_tpu_torch.cli_lora_pti:main" in f.read()
        sig = inspect.signature(cli_lora_pti.train)

        def stub(*a, **kw):
            return sig.bind(*a, **kw).arguments

        stub.__signature__ = sig
        got = Fire(stub, argv)
        assert set(got) == set(flags) and got["lora_rank"] == 1
    else:
        assert cmd[:3] == ["python", "-m",
                           "diffusion_finetuning_tpu_torch.training_scripts.train_lora_dreambooth"]
        from diffusion_finetuning_tpu_torch.training_scripts import train_lora_dreambooth

        args = train_lora_dreambooth.parse_args(argv)
        for k, v in flags.items():
            assert hasattr(args, k)
        assert args.max_train_steps == 30000 and args.instance_prompt == "style of sks"
