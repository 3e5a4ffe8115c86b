"""Package setup — mirrors the reference's console-script surface
(reference setup.py:14-18: lora_add, lora_pti, lora_distill) plus
pt-to-safetensors as a module CLI."""

import os

from setuptools import find_packages, setup

here = os.path.abspath(os.path.dirname(__file__))
with open(os.path.join(here, "README.md"), encoding="utf-8") as f:
    long_description = f.read()

setup(
    name="diffusion_finetuning_tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) LoRA fine-tuning for Stable Diffusion: "
        "DreamBooth, Pivotal Tuning Inversion, textual inversion, SVD "
        "distillation, merging, and txt2img/img2img inference."
    ),
    long_description=long_description,
    long_description_content_type="text/markdown",
    packages=find_packages(exclude=["tests", "tests.*"]),
    # the PyTorch port builds its CUDA kernels from these sources at first use
    package_data={"diffusion_finetuning_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    entry_points={
        "console_scripts": [
            "lora_add = diffusion_finetuning_tpu.cli_lora_add:main",
            "lora_pti = diffusion_finetuning_tpu.cli_lora_pti:main",
            "lora_distill = diffusion_finetuning_tpu.cli_svd:main",
            "lora_pti_torch = diffusion_finetuning_tpu_torch.cli_lora_pti:main",
            "lora_add_torch = diffusion_finetuning_tpu_torch.cli_lora_add:main",
            "lora_distill_torch = diffusion_finetuning_tpu_torch.cli_svd:main",
        ],
    },
    install_requires=["jax", "flax", "optax", "numpy", "Pillow"],
    python_requires=">=3.10",
)
