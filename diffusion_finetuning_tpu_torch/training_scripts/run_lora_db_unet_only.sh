#!/bin/bash
# DreamBooth, UNet-only LoRA (reference run_lora_db_unet_only.sh).
# On N cards of one host: replace `python -m` by `torchrun --nproc_per_node N -m`.
export MODEL_NAME="./models/stable-diffusion-2-1-base"
export INSTANCE_DIR="./data_example"
export OUTPUT_DIR="./output_example"

python -m diffusion_finetuning_tpu_torch.training_scripts.train_lora_dreambooth \
  --pretrained_model_name_or_path=$MODEL_NAME  \
  --instance_data_dir=$INSTANCE_DIR \
  --output_dir=$OUTPUT_DIR \
  --instance_prompt="style of sks" \
  --resolution=512 \
  --train_batch_size=1 \
  --gradient_accumulation_steps=1 \
  --learning_rate=1e-4 \
  --lr_scheduler="constant" \
  --lr_warmup_steps=0 \
  --max_train_steps=30000
