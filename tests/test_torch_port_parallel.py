"""The port's multi-device slice (``parallel/``, the mesh-bound train step,
``shard_over`` and the server's mesh branch) on the CPU.

One 2-rank gloo job per module (``tests/torch_port_dist_worker.py``, joined
through a ``file://`` rendezvous in ``tmp_path``, so xdist workers never race
for a port) runs every scenario in turn and writes its results; the tests
here hold them against JAX's and against the one-process port, at the tiny
configs in fp32:

* a data-parallel step (``data=2``; prior preservation and a face mask,
  ``train_batch_size`` 2 so that rank 0 holds only instance rows and rank 1
  only class rows) against JAX's step on an in-process 2-device ``data``
  mesh with JAX's draws handed over, and against the one-process port step;
  the same over two nodes of one rank each;
* ``tp=2``: the UNet and CLIP forwards and a train step against the unsplit
  run; ``shard_over`` with ``data=2`` and ``tp=2``; the server's rounded
  ladder and the follower loop; the process helpers.

Pure-Python checks hold ``trainer_mesh``'s rule and the ``fsdp_shardings`` /
``tp_shardings`` placements against JAX's on the same trees.

Tolerances: against JAX, the losses 1e-5 relative and the parameters within
1% of the LR a step (``tests/test_torch_port_training.py``: the same fp32
sums in another order, AdamW turning the gradients' relative noise of ~1e-5
into up to ~1e-3 of an update); against the one-process port the same
(the reduction over ranks sums the rows' terms in another order).  The
``tp=2`` forwards within 1e-5 absolute (the row-split layers' partial sums
add in another order; outputs are O(1)); images within one uint8 level (a
rounding flip), and ``shard_over(None)`` exactly (the gathered weights are
the original ones).
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from diffusion_finetuning_tpu import lora as jlora
from diffusion_finetuning_tpu.models import clip_text as jclip
from diffusion_finetuning_tpu.models import schedulers as jsched
from diffusion_finetuning_tpu.models import unet as junet
from diffusion_finetuning_tpu.parallel import mesh as jmesh
from diffusion_finetuning_tpu.training import optim as jopt
from diffusion_finetuning_tpu.training import train_step as jtrain

from diffusion_finetuning_tpu_torch.parallel import mesh as tmesh

from tests import torch_port_dist_worker as worker
from tests.torch_port_fixtures import (TRAINER_ATOL, numpy_lora_tree, step_keys, to_jax,
                                       trainer_dirs, trainer_draws)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_ATOL = 1e-2 * worker.LR  # a step
FWD_ATOL = 1e-5


def _inputs(dirs):
    ucfg, tcfg = junet.UNetConfig.tiny(), jclip.CLIPTextConfig.tiny()
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    ids = rng.integers(0, 1000, (4, 77)).astype(np.int64)
    keys = step_keys(jax.random.PRNGKey(5), 3)
    return {
        "model": dirs["model"], "root": str(dirs["root"]), "inst": dirs["inst"],
        "cls": dirs["cls"],
        "unet_lora": numpy_lora_tree(jlora.filter_targets(junet.unet_lora_targets(ucfg),
                                                          jlora.DEFAULT_TARGET_REPLACE), 2, 0),
        "text_lora": numpy_lora_tree(jclip.text_encoder_lora_targets(tcfg), 2, 1),
        # [instance x 2; class x 2], masks for the instance rows
        "dp_batch": {"pixel_values": px, "input_ids": ids,
                     "mask": rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)},
        "dp_keys": keys[:2],
        "dp_draws": [trainer_draws(k, 4, 1000) for k in keys[:2]],
        "nodes_draws": [trainer_draws(keys[2], 8, 1000)],
        "tp_batch": {"pixel_values": px[:2], "input_ids": ids[:2]},
        "tp_draws": [trainer_draws(k, 2, 1000) for k in keys[1:]],
    }


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The inputs and both ranks' results of one 2-rank gloo job."""
    dirs = trainer_dirs(tmp_path_factory)
    inp = _inputs(dirs)
    out = dirs["root"] / "dist"
    out.mkdir()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({k: v for k, v in inp.items() if k != "dp_keys"}, f)
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_WORLD_SIZE", "WORLD_SIZE")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_port_dist_worker", "--rank", str(r), "--world", "2",
         "--init", f"file://{out}/rendezvous", "--inputs", str(out / "inputs.pkl"),
         "--out", str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    return inp, [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


def _jax_dp(inp):
    """JAX's step on an in-process 2-device data mesh: (losses, flat
    parameters after each step) in the port's order."""
    from diffusion_finetuning_tpu.pipelines.pipeline import StableDiffusionPipeline as JPipe

    pipe = JPipe.from_pretrained(inp["model"])
    groups = {k: jopt.ParamGroup(lr=worker.LR) for k in ("unet_lora", "text_lora")}
    tx = jopt.multi_group_optimizer(groups, max_grad_norm=worker.MAX_NORM)
    step = jtrain.build_train_step(
        unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae,
        scheduler=jsched.DDPMScheduler(), optimizer=tx,
        partition=jtrain.TrainablePartition(unet_lora=True, text_lora=True),
        with_prior_preservation=True, prior_loss_weight=worker.PRIOR_W)
    params = {"unet_lora": to_jax(inp["unet_lora"]), "text_lora": to_jax(inp["text_lora"])}
    emb = pipe.text_params["token_embedding"]["embedding"]
    state = {"params": params,
             "static": {"unet_params": pipe.unet_params, "text_params": pipe.text_params,
                        "vae_params": pipe.vae_params, "orig_embeddings": emb,
                        "index_updates": jnp.zeros((emb.shape[0],), bool)},
             "opt_state": tx.init(params), "step": jnp.zeros((), jnp.int32)}
    mesh = jmesh.make_mesh(2)
    assert mesh.shape["data"] == 2
    jitted = jtrain.jit_train_step(step, mesh=mesh)
    state = jmesh.replicate(state, mesh)
    batch = jmesh.shard_batch(inp["dp_batch"], mesh)
    losses, flats = [], []
    for key in inp["dp_keys"]:
        state, m = jitted(state, batch, key)
        losses.append(float(m["loss"]))
        flats.append(np.concatenate([np.asarray(a, np.float32).ravel()
                                     for a in _sorted_leaves(jax.device_get(state["params"]))]))
    return np.array(losses), np.stack(flats)


def _sorted_leaves(tree):
    """Leaves in the order of the port's ``optim.trainable_tensors``."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) if k != "scale" for a in _sorted_leaves(tree[k])]
    return [tree]


def test_dp_step_matches_jax_mesh_and_one_process(job):
    inp, (r0, r1) = job
    np.testing.assert_array_equal(r0["dp_params"], r1["dp_params"])  # replicas agree
    np.testing.assert_array_equal(r0["dp_loss"], r1["dp_loss"])
    jl, jp = _jax_dp(inp)
    np.testing.assert_allclose(r0["dp_loss"], jl, rtol=1e-5)
    for s in range(2):
        _close(r0["dp_params"][s], jp[s], PARAM_ATOL * (s + 1))
    pipe = worker.load_pipe(inp)
    ol, op = worker.train_run(inp, pipe, None, inp["dp_batch"], inp["dp_draws"], True, 2)
    np.testing.assert_allclose(r0["dp_loss"], ol, rtol=1e-5)
    for s in range(2):
        _close(r0["dp_params"][s], op[s], PARAM_ATOL * (s + 1))
    assert np.abs(op[1] - op[0]).max() > 10 * PARAM_ATOL  # the steps move the LoRA


def test_dp_over_two_nodes_matches_one_process(job):
    """Two nodes of one rank each: the global batch is the nodes' batches
    end to end (8 rows; JAX's multi-host layout), the face masks gathered."""
    inp, (r0, r1) = job
    np.testing.assert_array_equal(r0["nodes_params"], r1["nodes_params"])
    batch = {k: np.concatenate([v, v]) for k, v in inp["dp_batch"].items()}
    pipe = worker.load_pipe(inp)
    ol, op = worker.train_run(inp, pipe, None, batch, inp["nodes_draws"], True, 1)
    np.testing.assert_allclose(r0["nodes_loss"], ol, rtol=1e-5)
    _close(r0["nodes_params"][0], op[0], PARAM_ATOL)


def test_tp_forwards_and_step_match_unsplit(job):
    _, (r0, r1) = job
    for r in (r0, r1):
        assert int(r["tp_split_layers"]) > 0
        assert tuple(r["tp_q_shape"]) == (4, 8)  # to_q's 8 outputs split over 2 ranks
        _close(r["tp_ctx"], r["tp_ref_ctx"], FWD_ATOL)
        _close(r["tp_eps"], r["tp_ref_eps"], FWD_ATOL)
        np.testing.assert_allclose(r["tp_loss"], r["tp_ref_loss"], rtol=1e-5)
        for s in range(2):
            _close(r["tp_params"][s], r["tp_ref_params"][s], PARAM_ATOL * (s + 1))
    np.testing.assert_array_equal(r0["tp_params"], r1["tp_params"])


def test_shard_over_matches_unsharded_pipe(job):
    _, (r0, r1) = job
    for r in (r0, r1):
        for key in ("so_data", "so_tp"):
            assert r[key].shape == r["so_ref"].shape == (4, 16, 16, 3)
            _close(r[key], r["so_ref"], 1)
        _close(r["so_data_i2i"], r["so_ref_i2i"], 1)
        for mode in ("merged", "dynamic"):  # a LoRA on the split UNet
            _close(r[f"so_tp_{mode}"], r[f"so_ref_{mode}"], 1)
        np.testing.assert_array_equal(r["so_back"], r["so_ref"])
        assert bool(r["so_odd_raised"])


def test_server_mesh_branch(job):
    _, (r0, r1) = job
    assert list(r0["srv_ladder"]) == [2, 4]  # 1 rounded up to the data size
    assert r0["srv_images"].shape == (4, 16, 16, 3)  # the last with adapter "a"
    _close(r0["srv_images"], r0["srv_ref"], 1)
    assert int(r1["srv_calls"]) >= 1


@pytest.mark.parametrize("kind", ["dreambooth", "w_ti", "pti"])
def test_trainers_on_two_ranks_match_one_process(job, kind):
    """DreamBooth and w_ti with ``data`` = 2 (prior preservation, one
    example a rank) and lora_pti with ``tensor_parallel=2``, through their
    entry points, against the same run in one process: losses 1e-5
    relative, trained tensors within the trainer tests' bound (2% of the
    largest LR an update, ``TRAINER_ATOL``), every rank alike."""
    inp, (r0, r1) = job
    np.testing.assert_array_equal(r0[f"{kind}_params"], r1[f"{kind}_params"])
    losses, params = worker.trainer_results(kind, inp, os.path.join(inp["root"], f"{kind}_one"))
    np.testing.assert_allclose(r0[f"{kind}_loss"], losses, rtol=1e-5)
    lr = 5 * worker.LR if kind == "pti" else worker.LR
    updates = 4 if kind == "pti" else 2
    _close(r0[f"{kind}_params"], params, TRAINER_ATOL * lr * updates)
    assert np.abs(params).max() > 0 and len(losses) == updates


def test_process_helpers(job):
    _, (r0, r1) = job
    assert bool(r0["main"]) and not bool(r1["main"])
    assert int(r0["local_batch"]) == int(r1["local_batch"]) == 4  # one node
    assert float(r0["barrier_wait_s"]) >= 0.4  # rank 0 waited for rank 1
    # shard_batch along the second axis (a multi_step stack): each rank's half
    for r, res in enumerate((r0, r1)):
        np.testing.assert_array_equal(res["shard_x"], np.arange(8).reshape(4, 2)[:, r:r + 1])
        assert res["shard_y"].shape == (2, 2)


def _fake_mesh(**shape):
    return tmesh.Mesh(tuple(shape), dict(shape), 0, {k: 0 for k in shape}, {}, None,
                      "cpu", "gloo")


@pytest.mark.parametrize("world,eff_batch,tp", [(8, 2, 1), (8, 4, 2), (8, 3, 1), (4, 8, 4),
                                                (8, 1, 1), (6, 4, 2)])
def test_trainer_mesh_rule_matches_jax(monkeypatch, world, eff_batch, tp):
    seen = {}
    monkeypatch.setattr(jax, "devices", lambda *a, real=jax.devices(): real[:world])
    jm = jmesh.trainer_mesh(eff_batch, tp)
    monkeypatch.setattr(tmesh, "_world", lambda: (0, world))
    monkeypatch.setattr(tmesh, "make_mesh", lambda num_devices=None, axes=("data",),
                        shape=None, device=None: seen.update(
                            shape=dict(zip(axes, shape or (num_devices,)))) or "mesh")
    tm = tmesh.trainer_mesh(eff_batch, tp)
    assert (jm is None) == (tm is None)
    if jm is not None:
        assert seen["shape"] == dict(jm.shape)


def test_trainer_mesh_rejects_indivisible_tp(monkeypatch):
    monkeypatch.setattr(tmesh, "_world", lambda: (0, 6))
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.trainer_mesh(4, 4)


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    from diffusion_finetuning_tpu.pipelines.pipeline import StableDiffusionPipeline as JPipe

    pipe = JPipe.from_pretrained(trainer_dirs(tmp_path_factory)["model"])
    return {"unet": jax.device_get(pipe.unet_params),
            "text": jax.device_get(pipe.text_params)}


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("which", ["unet", "text"])
def test_placements_match_jax(jax_trees, which):
    tree = jax_trees[which]
    devs = np.array(jax.devices()[:8])
    jtp = jmesh.tp_shardings(Mesh(devs[:2].reshape(1, 2), ("data", "tp")), tree)
    ttp = tmesh.tp_shardings(_fake_mesh(data=1, tp=2), tree)
    jfs = jmesh.fsdp_shardings(Mesh(devs.reshape(2, 4), ("data", "fsdp")), tree, min_size=256)
    tfs = tmesh.fsdp_shardings(_fake_mesh(data=2, fsdp=4), tree, min_size=256)
    split = 0
    for (path, _), (_, j), (_, t), (_, jf), (_, tf) in zip(
            _leaves_with_paths(tree), _leaves_with_paths(jtp), _leaves_with_paths(ttp),
            _leaves_with_paths(jfs), _leaves_with_paths(tfs)):
        assert tuple(j.spec) == t, path
        assert tuple(jf.spec) == tf, path
        split += any(t)
    assert split > 0


def test_tp_state_shardings_replicate_the_port_state():
    mesh = _fake_mesh(data=1, tp=2)
    state = {"params": {"unet_lora": {"a": {"up": np.zeros((4, 2))}}}, "step": 0,
             "static": {"unet_params": {"b": {"to_q": {"kernel": np.zeros((8, 8))}}}}}
    sh = tmesh.tp_state_shardings(mesh, state)
    assert sh["params"]["unet_lora"]["a"]["up"] == () and sh["step"] == ()
    assert sh["static"]["unet_params"]["b"]["to_q"]["kernel"] == (None, "tp")


def test_mesh_dataclass_is_hashable_by_identity():
    a, b = _fake_mesh(data=2), _fake_mesh(data=2)
    assert len({a, b, a}) == 2 and dataclasses.is_dataclass(a)
