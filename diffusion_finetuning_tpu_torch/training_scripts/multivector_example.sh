#!/bin/bash
# Multi-vector PTI with face conditioning (reference multivector_example.sh):
# three placeholder vectors, one seeded from "girl", two random.
export MODEL_NAME="./models/stable-diffusion-v1-5"
export INSTANCE_DIR="./data/data_person"
export OUTPUT_DIR="./exps/output_person"

lora_pti_torch \
  --pretrained_model_name_or_path=$MODEL_NAME  \
  --instance_data_dir=$INSTANCE_DIR \
  --output_dir=$OUTPUT_DIR \
  --train_text_encoder \
  --resolution=512 \
  --train_batch_size=1 \
  --gradient_accumulation_steps=4 \
  --scale_lr \
  --learning_rate_unet=1e-4 \
  --learning_rate_text=1e-5 \
  --learning_rate_ti=5e-4 \
  --color_jitter \
  --lr_scheduler="linear" \
  --lr_warmup_steps=0 \
  --placeholder_tokens="<s1>|<s2>|<s3>" \
  --initializer_tokens="girl|<rand-0.5>|<rand-0.5>" \
  --use_template="object" \
  --save_steps=100 \
  --max_train_steps_ti=1000 \
  --max_train_steps_tuning=1000 \
  --perform_inversion=True \
  --clip_ti_decay=True \
  --weight_decay_ti=0.000 \
  --weight_decay_lora=0.001 \
  --continue_inversion=True \
  --continue_inversion_lr=1e-4 \
  --use_face_segmentation_condition=True \
  --lora_rank=1
