"""Joint LoRA + TI trainer with filename-stem captions (port of the JAX
repo's ``training_scripts/train_lora_pt_caption.py``; the reference's
523-1072).

The staged TI-then-LoRA schedule of :mod:`.train_lora_w_ti` (865-874), but
each image's caption is its filename stem (train_lora_pt_caption.py:137-145)
and only ``.pt`` files are written (1059-1065): the same flags and train
step with the caption source swapped.

Run: ``python -m diffusion_finetuning_tpu_torch.training_scripts.train_lora_pt_caption
--pretrained_model_name_or_path MODEL --instance_data_dir DIR --placeholder_token
"<krk>" --initializer_token dog [--flag value ...]``.
"""

from __future__ import annotations

from ..data.dataset import PivotalTuningDatasetCapation
from . import train_lora_w_ti as base


def parse_args(input_args=None):
    args = base.parse_args(input_args)
    args.output_format = "pt"  # reference pt_caption saves .pt only (1059-1065)
    return args


class _CaptionDataset(PivotalTuningDatasetCapation):
    """Filename-stem captions (train_lora_pt_caption.py:137-145), with the
    constructor surface of ``DreamBoothTiDataset``."""

    def __init__(self, *, instance_data_root, placeholder_token, stochastic_attribute,
                 learnable_property, class_data_root, class_prompt, tokenizer, size,
                 center_crop, color_jitter, resize, seed=None):
        del placeholder_token, stochastic_attribute, learnable_property, center_crop
        super().__init__(instance_data_root=instance_data_root, tokenizer=tokenizer,
                         token_map=None, use_template=None, class_data_root=class_data_root,
                         class_prompt=class_prompt, size=size, color_jitter=color_jitter,
                         resize=resize, seed=seed)


def main(args, device="cuda"):
    return base.main(args, dataset_cls=_CaptionDataset, device=device)


if __name__ == "__main__":
    main(parse_args())
