"""The reference's notebook workflows as modules of the port (counterparts
of the repo's ``scripts/*.py``, which drive the JAX package), each run as
``python -m diffusion_finetuning_tpu_torch.scripts.<name>`` with the JAX
script's flags and ``--device`` (the card unless ``cpu`` is asked for)."""
