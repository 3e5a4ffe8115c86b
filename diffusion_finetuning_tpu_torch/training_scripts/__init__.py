"""The training scripts (ports of the JAX repo's ``training_scripts/``),
run as ``python -m diffusion_finetuning_tpu_torch.training_scripts.<name>``:
``train_lora_dreambooth``, ``train_lora_w_ti`` and ``train_lora_pt_caption``."""
