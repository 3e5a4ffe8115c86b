"""The port's notebook scripts (``diffusion_finetuning_tpu_torch/scripts``)
at tiny size on the CPU, writing their outputs as the JAX scripts' tests
check them (``tests/test_cli_tools.py::test_run_inference_script`` and
``test_sweep_lr_script``): a LoRA with a TI embed from the port's
``pt_to_safetensors``, the port's tiny pipe written by ``save_pretrained``.
The scripts that render at the pipe's default 512^2 run with requests
shrunk to 16^2 (the tiny VAE's mid-block attention at 512^2 would hold
256^2 x 256^2 scores).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_finetuning_tpu_torch import lora as tlora
from diffusion_finetuning_tpu_torch.cli_pt_to_safetensors import convert
from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline
from diffusion_finetuning_tpu_torch.scripts import (make_alpha_gifs, merge_lora_with_lora,
                                                    run_img2img, run_inference, sweep_lr,
                                                    visualize_training_progress)

from tests.torch_port_fixtures import small_images, trainer_dirs  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny model directory and two LoRA files with a TI token each:
    (dirs, [safetensors A, safetensors B], UNet targets)."""
    dirs = trainer_dirs(tmp_path_factory)
    pipe = StableDiffusionPipeline.from_pretrained(dirs["model"], device="cpu")
    targets = pipe.lora_targets("unet", tlora.DEFAULT_TARGET_REPLACE)
    root = tmp_path_factory.mktemp("port_scripts")
    paths = []
    for i in range(2):
        g = torch.Generator().manual_seed(7 + i)
        flat = [torch.randn(s, generator=g).half() * 0.5 for t in targets
                for s in ((t.out_features, 2), (2, t.in_features))]
        pt, ti = str(root / f"lora{i}.pt"), str(root / f"lora{i}.ti.pt")
        torch.save(flat, pt)
        torch.save({"<s1>": 0.01 * torch.randn(32, generator=g)}, ti)
        paths.append(str(root / f"lora{i}.safetensors"))
        convert(pt, ti, outpath=paths[-1], **{"unet.rank": 2})
    return dirs, paths, targets


def test_run_inference_script(setup, tmp_path):
    dirs, (lora, _), _ = setup
    out = str(tmp_path / "img.png")
    run_inference.run(dirs["model"], lora, prompt="a photo of <s1>", out=out, n=2,
                      height=64, width=64, steps=2, scheduler="dpm", unet_scale=0.7, seed=3,
                      dtype="float32", device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["img-0.png", "img-1.png"]
    for p in ("img-0.png", "img-1.png"):
        assert Image.open(tmp_path / p).size == (64, 64)


def test_run_img2img_script(setup, tmp_path):
    """``dpm`` img2img from a PNG, through the sampler's restart."""
    dirs, (lora, _), _ = setup
    init = str(tmp_path / "init.png")
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8)).save(init)
    out = str(tmp_path / "out.png")
    run_img2img.run(dirs["model"], lora, init, out, prompt="a photo of <s1>", strength=0.6,
                    steps=4, scheduler="dpm", seed=1, device="cpu")
    img = np.asarray(Image.open(out))
    assert img.shape == (64, 64, 3) and img.std() > 0


def test_sweep_lr_script(setup, tmp_path):
    """Two points of one train step (runtime lr_scale): per-point
    trajectories and the best LoRA on disk; each point starts from the
    same state, so the trajectories' first losses agree."""
    dirs, _, targets = setup
    inst = tmp_path / "inst"
    inst.mkdir()
    Image.fromarray(np.full((16, 16, 3), 90, np.uint8)).save(inst / "a.png")
    out = str(tmp_path / "out")
    sweep_lr.run(dirs["model"], str(inst), out, prompt="a photo of sks", base_lr=1e-3,
                 scales="0.5,2", steps=4, rank=1, resolution=16, steps_per_dispatch=2,
                 mixed_precision="no", device="cpu")
    with open(os.path.join(out, "sweep.json")) as f:
        sweep = json.load(f)
    assert set(sweep) == {"0.5", "2.0"}
    assert all(len(v["losses"]) == 4 for v in sweep.values())
    assert sweep["0.5"]["losses"][0] == sweep["2.0"]["losses"][0]
    assert sweep["0.5"]["losses"][1:] != sweep["2.0"]["losses"][1:]
    flat = torch.load(os.path.join(out, "lora_best.pt"), weights_only=True)
    assert len(flat) == 2 * len(targets)


def test_merge_lora_with_lora_script(setup, tmp_path, small_images):
    dirs, (a, b), _ = setup
    out = str(tmp_path / "grid.png")
    merge_lora_with_lora.merge(dirs["model"], a, b.replace(".safetensors", ".pt"), out,
                               steps=2, device="cpu")
    assert Image.open(out).size == (5 * 16, 16)


def test_make_alpha_gifs_script(setup, tmp_path, small_images):
    dirs, (lora, _), _ = setup
    out = str(tmp_path / "out.gif")
    make_alpha_gifs.sweep(dirs["model"], lora, out, frames=3, steps=2, device="cpu")
    gif = Image.open(out)
    assert gif.size == (16, 16) and gif.n_frames >= 2


def test_visualize_training_progress_script(setup, tmp_path, small_images):
    dirs, paths, _ = setup
    out = str(tmp_path / "progress.png")
    visualize_training_progress.run(dirs["model"], paths, out, steps=2, device="cpu")
    grid = np.asarray(Image.open(out))
    assert grid.shape == (16, 2 * 16, 3)
    assert not np.array_equal(grid[:, :16], grid[:, 16:])
