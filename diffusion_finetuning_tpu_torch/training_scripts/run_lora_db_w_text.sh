#!/bin/bash
# DreamBooth with text-encoder LoRA (reference run_lora_db_w_text.sh).
# On N cards of one host: replace `python -m` by `torchrun --nproc_per_node N -m`.
export MODEL_NAME="./models/stable-diffusion-v1-5"
export INSTANCE_DIR="./data_example"
export OUTPUT_DIR="./output_example_text"

python -m diffusion_finetuning_tpu_torch.training_scripts.train_lora_dreambooth \
  --pretrained_model_name_or_path=$MODEL_NAME  \
  --instance_data_dir=$INSTANCE_DIR \
  --output_dir=$OUTPUT_DIR \
  --instance_prompt="style of sks" \
  --resolution=512 \
  --train_batch_size=1 \
  --gradient_accumulation_steps=1 \
  --learning_rate=1e-4 \
  --learning_rate_text=5e-5 \
  --train_text_encoder \
  --color_jitter \
  --lr_scheduler="constant" \
  --lr_warmup_steps=0 \
  --max_train_steps=30000
