"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile DIR   # also the UNet and train steps' device profiles

Phases, each fatal on failure:
  1. device and build: prints the card (nvidia-smi name, power limit) and
     builds every kernel of ``diffusion_finetuning_tpu_torch/csrc`` with nvcc,
     one process per source, all at once;
  2. kernels against their plain PyTorch versions on the card, bf16, at every
     shape the SD1.5 512^2 main paths give them (the flash backward at the
     training shapes, BH = 8): error, kernel time, plain-version time, one
     PyTorch library call's time (SDPA's backward alone for the flash
     backward), and the bound; then each kernel's fp32 variant, which the
     fp32 pipes (``visualize_training_progress``) and the default fp32
     trainers run, in a row of its own with its own launch counter, at the
     same shapes in fp32 against its plain version within its fp32 gate
     (FLASH_F32_TOL, FLASH_BWD_F32_TOL, LORA_F32_TOL, CONV_F32_TOL),
     repeating bit for bit, beside one library call in fp32 (TF32 off) and
     two bounds (``bound_f32``: the split product on the tensor cores, and
     the fp32 FMA rate), K2's also at the text encoder's projections
     (TEXT_LORA_ROW) and summed over an fp32 DreamBooth step's forward, K2's
     and K5's beside the FMA kernels they replaced (``K2F32_PREV``,
     ``K5F32_PREV``, log only); the flash forward's q tile and the flash
     backward's q splits (whose dQ, dK and dV must repeat bit for bit, and
     whose dQ must not change with the splits), each timed beside the
     choices its rule did not make (the other tile; half and twice the
     splits) and beside the time of the first design of each and of the
     designs the last commit replaced (constants below);
  3. the UNet step of ``entry()``: full SD1.5 width in bf16 with a rank-4
     dynamic LoRA (non-zero up), CFG batch 2 at 64x64 latents, through both
     kernels, held against the same UNet run on the CPU in fp32 through the
     plain versions, and timed with and without the LoRA;
  4. serving: txt2img at 128^2 (3 steps) held against the same pipeline in
     fp32 on the CPU, then the main path, txt2img requests through
     ``StableDiffusionPipeline.__call__`` (512^2, 50 DDIM steps, CFG, seeds)
     with the LoRA merged and dynamic; the kernels' launch counters are set
     to 0 just before the requests and read just after, and must show 32
     flash launches per UNet step and 144 LoRA launches per dynamic step;
  5. training: one ``loss_step`` and its backward at full SD1.5 width in
     bf16 on the card held against the same step in fp32 on the CPU (same
     LoRA, same cached latent moments, same draws), then the training path,
     ``build_train_step`` at 512^2, batch 1, uint8 pixels, rank-4 LoRA,
     AdamW with max_grad_norm 1.0: 2 warm-up and 10 timed steps with the
     launch counters set to 0 just before the 10 and read just after (32
     flash forward, 32 flash backward and 144 LoRA launches a step), then
     one step with gradient checkpointing (64 / 32 / 288);
  6. the opt-in kernel path, both switches on (``DFT_CONV_PALLAS``: the
     UNet's resnet 3x3 convs through the fused conv K5; head packing G = 2:
     every flash forward through K4): one UNet step against phase 3's CPU
     fp32 run; img2img at 128^2 against the same call on the CPU in fp32
     (same draws); then the main path of this phase, img2img requests
     through ``StableDiffusionPipeline.img2img`` (512^2, 50 DDIM steps,
     strength 0.75 so 38 UNet steps, CFG, dynamic LoRA) with exact launch
     counts (37 K5, 32 K4, 144 K2 a UNet step, no K1); merged serving with
     a LoRA on the resnet convs too, whose second request must make no
     tap-major weight copy (``conv3x3.tap_major_copies``); then training: one
     ``loss_step`` + backward against phase 5's CPU fp32 gradient, 1 + 4
     ``build_train_step`` steps (37 K5, 32 K4, 32 K3, 144 K2 a step) and
     one checkpointed step (72 / 64 / 32 / 288: the first resnet block,
     which needs no gradient, is not recomputed).  Phase 2 also holds K5
     against its plain version at every routed SD1.5 conv shape (batch 2
     and 1), and K4 (G = 2 and 4, at both q tiles) equal to K1 bit for bit
     at every flash shape, timed beside K1 in the same run; and the NHWC
     GroupNorm (no TPU counterpart) at every GroupNorm shape of an SD1.5
     UNet step, an SD 2.1 768^2 batch-8 UNet step and a 768^2 VAE decode of
     4 images, beside PyTorch's GroupNorm + SiLU on NCHW;
  7. graphed: the main paths through their CUDA graphs (``graph.py``), each
     beside its eager run -- 512^2 txt2img (50 DDIM steps, CFG 7.5) at
     batches 1 and 2 with the LoRA merged and dynamic (``__call__``), the
     switched img2img request (``img2img``), and the train step at spd 1
     (``jit_train_step``) and 4 (``multi_step``), switches off and on.  Each
     graphed result must equal the eager one bit for bit (images; losses,
     LoRA masters, moments and counts from equal states and generators);
     the launch counters, set to 0 just before a path's first graphed call,
     must read twice its launches (the warm-up and the capture) and no
     more after GRAPH_REPEATS replays, and one replay traced with torch.profiler must
     run them on the device (traced again, up to TRACE_ATTEMPTS times, where
     a trace lost records and saw fewer).  Printed for both: wall ms (median and range
     of GRAPH_REPEATS calls; of EAGER_REQUESTS eager requests), requests or steps a second,
     device-busy ms and kernels of one traced call, idle share (1 - busy /
     median wall), peak memory, tap-major copies the graph holds; for the
     graph its first call (warm-up, capture, replay).  ``--profile DIR``
     also writes the kernel tables of one graphed dynamic-LoRA image and
     one graphed train step;
  8. the serving entry point: the pipe written as a diffusers directory in
     bf16 (``save_pretrained``) and read back (``from_pretrained``), every
     tensor equal; adapter A (UNet and text rank-4 LoRA, one TI token) in
     one safetensors and adapter B as a ``.pt`` triple, read back bit for
     bit (B's pairs as fp16); ``patch_pipe`` A, then B, then
     ``tune_lora_scale_pipe`` at one request key (512^2, 30 steps, "dpm"):
     one graph captured, each image equal to the eager one, the merge and
     buffer-copy ms of each swap, memory not grown by a merged set; then
     ``GenerationServer(max_batch=4)`` with A merged and B dynamic (K2):
     bursts of 12 requests from 4 threads (adapters None, A, B with "dpm",
     "euler_a", "ddim") until one captures no graph, the launch counters,
     set to 0 just before each burst, equal to what its newly captured
     graphs launch (warm-up and capture), every image within PIPE_MEAN_ABS
     of its lone batch-1 run; requests a second and latency p50/p95;
  9. the trainers, from phase 8's bf16 directory and 4 seeded 512^2
     images, each run through its entry point on the card: ``cli_lora_pti.train``
     (8 inversion steps with gradient accumulation 2, then 8 tuning steps
     with the text LoRA and continued inversion; rank 4, saves every 4 steps,
     4 steps a CUDA graph), then the returned pipe serving one graphed
     request with ``<s1> <s2>`` (and one without the LoRA, which must
     differ); ``train_lora_dreambooth.main`` with prior preservation (2 class
     images synthesised through graphed requests at 10 steps), the text LoRA
     and full-state checkpoints, then a second run resumed from the step-4
     checkpoint (restored state bit-equal to the saved one, "Resumed at step
     4", step 8 reached); ``train_lora_dreambooth.main`` again with no
     ``--mixed_precision``, the default fp32 trainer (8 steps, the fp32
     kernels only; its peak memory printed beside the bytes of the fp32
     kernels' split copies in a step), then one graphed step of its step
     function against its
     eager twin bit for bit, switches off and with the conv switch on (K5's
     fp32 kernel); ``train_lora_w_ti.main`` for 8 steps.  Fatal
     unless every loss is finite, the checkpoint and output files read back,
     the inversion leaves every frozen embedding row bit-equal, the LoRA
     moved, and the launch counts are exact: a TI step 32 K1 and 31 K3 (the
     first transformer block's attn1 needs no gradient), a LoRA step 32 K1,
     32 K3 and 192 K2 (fp32: on the fp32 kernels' counters), twice a graph's
     steps at its warm-up and capture, none at its replays.  Printed: each
     phase's first dispatch s, steps a second after it, peak memory,
     checkpoint save and restore ms;
 10. the rest of one card's surface, from phase 8's directory and adapters:
     img2img at 512^2, strength 0.75, 20 steps (15 UNet steps, PNDM 16),
     batch 1, adapter B dynamic (K1, K2), with the "dpm", "pndm", "euler",
     "euler_a", "lms" and "lms:karras" samplers, each graphed request equal
     to its eager twin bit for bit, launches twice a call at the capture and
     none at the replays (printed: first-call s, graphed and eager ms, peak
     memory); "lms" and "euler_a" at 128^2 against the CPU in fp32 (same
     draws); ``lora_add`` ``upl`` of B into the directory (fp32, each merged
     weight equal to ``weight_apply_lora``), ``upl-ckpt-v2`` (an fp16 .ckpt
     read back with ``torch.load(weights_only=True)``) and ``lpl`` of A's
     and B's ``.pt`` pairs; ``lora_distill`` at rank 4 with its SVDs on the
     card, each pair before the clamp within DISTILL_REL_FRO of 0.8 x B's up
     down; the ``run_img2img`` (bf16) and ``visualize_training_progress``
     (fp32, as in JAX: K1's fp32 kernel) scripts with exact launches.
     Printed: seconds and bytes of each tool;
 11. the multi-device slice (``parallel/``) on the one card, from phase 8's
     directory: (a) ``train_lora_dreambooth.main`` in fp32 (its default)
     for one step with prior preservation and the text LoRA, over two ranks
     sharing the card (child processes of this script, gloo, ``data`` = 2,
     one example a rank: rank 0 the instance row, rank 1 the class row),
     against the same trainer in one process at batch 2 with the same draws
     (the summed LoRA gradient within PAR_GRAD_REL_L2, the LoRA update
     within PAR_UPDATE_REL_L2, the loss within PAR_LOSS_RTOL, each rank's
     launches one fp32 step's); (b) an eager bf16 CFG UNet step
     at 64x64 latents with a dynamic LoRA and ``tp`` = 2 (``parallel/tp.py``:
     to_q 160 x 320 on a rank, 4 heads) against the unsplit step within
     PAR_TP_REL_L2, each rank launching 32 K1 and 144 K2; (c) one graphed
     DreamBooth step through a one-rank NCCL mesh passed to
     ``FusedDispatcher`` (the gradient all-reduce captured in the CUDA
     graph), equal bit for bit to the mesh-free graphed step;
 12. SD 2.1 (stabilityai/stable-diffusion-2-1, 768-v) at its published
     widths (``sd21_configs``: heads of 64 in every block, cross-attention
     width 1024, linear proj_in/proj_out, OpenCLIP ViT-H text tower,
     v-prediction), seeded random weights rounded to bf16 once, a rank-4
     LoRA: (a) ``save_pretrained`` / ``from_pretrained`` (every SD2 field
     read back, every tensor equal); (b) a CFG UNet step at 96x96 latents,
     eager (32 K1, 144 K2) and graphed (equal), against the CPU fp32 UNet
     within UNET_REL_L2; (c) 128^2 3-step txt2img against the CPU fp32 pipe
     within PIPE_MEAN_ABS; (d) the 768^2 50-step image, SD21_EAGER eager and
     SD21_GRAPHED graphed calls after the capturing one, every graphed image
     equal to the eager one; (e) one bf16 ``loss_step`` + backward at 768^2
     under the v target against the CPU fp32 one within TRAIN_GRAD_REL_L2,
     then ``jit_train_step``: the capture and SD21_TRAIN_REPLAYS timed
     replays; (f) ``train_lora_dreambooth`` from (a)'s directory at 768^2 in
     fp32, SD21_DB_STEPS steps at SD21_DB_SPD a graph.  Launches exact in
     each; phase 2's ``sd21_rows`` time K1, K3 and K2 (bf16 and fp32) at
     these shapes in rows of their own, ``sdxl_rows`` K1, K2 and the NHWC
     GroupNorm (bf16) at phase 13's (UNet, towers and 1024^2 VAE decode);
 13. SDXL 1.0 base (``phase_sdxl``) at its published widths, seeded random
     weights drawn on the card, a rank-4 dynamic LoRA on the UNet and both
     towers: a 1024^2 batch of 2, 20 Euler steps, eager (140 K1 and 630 K2
     a UNet step, 172 K2 in the towers, the predicted NHWC GroupNorms, no
     GroupNorm fallback, 70 transformer blocks a UNet call, 2 towers) and
     through its CUDA graph, equal bit for bit.  Phases 4 and 12 hold SD
     1.5's and SD 2.1's UNets at 16 transformer blocks a call
     (``unet.transformer_blocks``).

Weights are random from fixed seeds (no checkpoint is read).  The last lines
are the kernels JSON line, the card's ``name, power.limit`` line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# (Sq, Skv, head dim, calls per UNet step) of SD1.5 at 512^2 with CFG
# (batch 2 x 8 heads): attn1 is self-attention, attn2 attends to the 77 text
# tokens; levels 64^2/32^2/16^2 have 5 transformer blocks each, the 8^2 mid
# block one.  Training runs the same calls at batch 1 (8 heads), forward and
# backward.
FLASH_SHAPES = [
    (4096, 4096, 40, 5), (1024, 1024, 80, 5), (256, 256, 160, 5), (64, 64, 160, 1),
    (4096, 77, 40, 5), (1024, 77, 80, 5), (256, 77, 160, 5), (64, 77, 160, 1),
]
FLASH_BH = 16
FLASH_BWD_BH = 8  # training: batch 1 without CFG
# per-call ms of the first designs at FLASH_SHAPES, measured by this script
# on an NVIDIA H100 80GB HBM3 at 700 W: K1 (mma.sync, 64-row tiles,
# synchronous K/V copies) at commit e5aeca8, BH = 16; K3 (one CTA per 64 KV
# rows, unsplit q loop) at commit a9e0f8c, BH = 8; printed in the log
# beside this run's times, and kept out of the kernels line, whose numbers
# are all this run's
K1_PREV = ("first K1, e5aeca8", {
    (4096, 4096, 40): 0.5247, (1024, 1024, 80): 0.0989, (256, 256, 160): 0.0568,
    (64, 64, 160): 0.0218, (4096, 77, 40): 0.0280, (1024, 77, 80): 0.0200,
    (256, 77, 160): 0.0286, (64, 77, 160): 0.0281})
K3_PREV = ("first K3, a9e0f8c", {
    (4096, 4096, 40): 0.6295, (1024, 1024, 80): 0.2025, (256, 256, 160): 0.1111,
    (64, 64, 160): 0.0441, (4096, 77, 40): 0.5096, (1024, 77, 80): 0.1924,
    (256, 77, 160): 0.1042, (64, 77, 160): 0.0404})
# (M tokens, K, N, calls per UNet step) of the LoRA'd projections: per block
# attn1 q/k/v/out + attn2 q/out (C->C), attn2 k/v (77x2 text tokens, 768->C),
# GEGLU proj (C->8C)
LORA_SHAPES = []
for _m, _c, _blocks in ((8192, 320, 5), (2048, 640, 5), (512, 1280, 5), (128, 1280, 1)):
    LORA_SHAPES += [(_m, _c, _c, 6 * _blocks), (154, 768, _c, 2 * _blocks),
                    (_m, _c, 8 * _c, _blocks)]
# training runs the same projections at batch 1: half the image rows, 77
# text rows
LORA_TRAIN_SHAPES = []
for _m, _c, _blocks in ((4096, 320, 5), (1024, 640, 5), (256, 1280, 5), (64, 1280, 1)):
    LORA_TRAIN_SHAPES += [(_m, _c, _c, 6 * _blocks), (77, 768, _c, 2 * _blocks),
                          (_m, _c, 8 * _c, _blocks)]
# the text encoder's LoRA'd projections in an fp32 DreamBooth step with prior
# preservation: (M = one instance and one class prompt of 77 tokens, K, N,
# calls: 12 CLIP layers x q, k, v, out)
TEXT_LORA_ROW = (154, 768, 768, 48)
LORA_RANK = 4
FLASH_PER_STEP = sum(s[3] for s in FLASH_SHAPES)   # 32
LORA_PER_STEP = sum(s[3] for s in LORA_SHAPES)     # 144
assert LORA_PER_STEP == sum(s[3] for s in LORA_TRAIN_SHAPES)
# per-call ms of the designs before this script's, measured by this script
# on an NVIDIA H100 80GB HBM3 at 700 W at commit 578b4ea: K2 (its first
# design: mma.sync kernel, 128x128 tiles, two-stage cp.async ring) at the serving
# shapes (M, K, N), K5 (its first design: mma.sync implicit GEMM with element-gathered
# pixels) at (B, C, H, W, O); printed in the log only, never in the kernels
# line, whose numbers are all this run's
K2_PREV = ("first K2, 578b4ea", {
    (8192, 320, 320): 0.0328, (154, 768, 320): 0.0361, (8192, 320, 2560): 0.1522,
    (2048, 640, 640): 0.0325, (154, 768, 640): 0.0358, (2048, 640, 5120): 0.1237,
    (512, 1280, 1280): 0.0493, (154, 768, 1280): 0.0348, (512, 1280, 10240): 0.1208,
    (128, 1280, 1280): 0.0506, (128, 1280, 10240): 0.0535})
K5_PREV = ("first K5, 578b4ea", {
    (2, 320, 64, 64, 320): 0.2910, (2, 320, 32, 32, 640): 0.2334,
    (2, 640, 32, 32, 640): 0.4611, (2, 640, 16, 16, 1280): 0.4494,
    (2, 1280, 16, 16, 1280): 0.8957, (2, 1280, 8, 8, 1280): 0.8960,
    (2, 1280, 32, 32, 640): 0.9197, (2, 960, 32, 32, 640): 0.6876,
    (2, 960, 64, 64, 320): 0.8530, (2, 640, 64, 64, 320): 0.5756,
    (1, 320, 64, 64, 320): 0.2348, (1, 320, 32, 32, 640): 0.2322,
    (1, 640, 32, 32, 640): 0.4604, (1, 640, 16, 16, 1280): 0.4476,
    (1, 1280, 16, 16, 1280): 0.8842, (1, 1280, 8, 8, 1280): 0.8728,
    (1, 1280, 32, 32, 640): 0.9185, (1, 960, 32, 32, 640): 0.6861,
    (1, 960, 64, 64, 320): 0.6959, (1, 640, 64, 64, 320): 0.4650})

# per-call ms of the designs these replaced, measured by this script's phase
# 2 (flash_packed_rows, flash_bwd_rows) at commit e663ccd on an NVIDIA H100
# 80GB HBM3 at 700 W, the mean of two runs in one call: K4 (K1's body for
# the G heads in turn, at K1's tile) at (G, Sq, Skv, d), BH = 16; K3 with dQ
# added by bulk reduce-adds and atomics in no fixed order, BH = 8; printed
# in the log only
K4_PREV = ("K4 before, e663ccd", {
    (2, 4096, 4096, 40): 0.1912, (2, 1024, 1024, 80): 0.0411, (2, 256, 256, 160): 0.0195,
    (2, 64, 64, 160): 0.0132, (2, 4096, 77, 40): 0.0212, (2, 1024, 77, 80): 0.0167,
    (2, 256, 77, 160): 0.0155, (2, 64, 77, 160): 0.0147,
    (4, 4096, 4096, 40): 0.2267, (4, 1024, 1024, 80): 0.0761, (4, 256, 256, 160): 0.0354,
    (4, 64, 64, 160): 0.0231, (4, 4096, 77, 40): 0.0242, (4, 1024, 77, 80): 0.0269,
    (4, 256, 77, 160): 0.0272, (4, 64, 77, 160): 0.0270})
K3_UNORDERED = ("K3 before, e663ccd", {
    (4096, 4096, 40): 0.3289, (1024, 1024, 80): 0.0689, (256, 256, 160): 0.0406,
    (64, 64, 160): 0.0236, (4096, 77, 40): 0.0341, (1024, 77, 80): 0.0347,
    (256, 77, 160): 0.0371, (64, 77, 160): 0.0239})

# per-call ms of the fp32 FMA kernels the split-product kernels replaced
# (lora_dense_f32_kernel, conv3x3_f32_kernel), measured by this script's
# phase 2 (lora_fp32_rows, conv3x3_fp32_rows) at commit 6d5a880 on an NVIDIA
# H100 80GB HBM3 at 700 W: K2 at (M, K, N), rank 4, K5 at (B, C, H, W, O);
# printed in the log only
K2F32_PREV = ("K2 fp32 FMA, 6d5a880", {
    (8192, 320, 320): 0.2564, (154, 768, 320): 0.2090, (8192, 320, 2560): 1.8519,
    (2048, 640, 640): 0.3085, (154, 768, 640): 0.2102, (2048, 640, 5120): 1.8664,
    (512, 1280, 1280): 0.4268, (154, 768, 1280): 0.2092, (512, 1280, 10240): 1.9347,
    (128, 1280, 1280): 0.3729, (128, 1280, 10240): 0.6691, (4096, 320, 320): 0.1593,
    (77, 768, 320): 0.2059, (4096, 320, 2560): 0.9565, (1024, 640, 640): 0.2173,
    (77, 768, 640): 0.2059, (1024, 640, 5120): 0.9523, (256, 1280, 1280): 0.3634,
    (77, 768, 1280): 0.2087, (256, 1280, 10240): 1.0316, (64, 1280, 1280): 0.3793,
    (64, 1280, 10240): 0.4834})
K5F32_PREV = ("K5 fp32 FMA, 6d5a880", {
    (2, 320, 64, 64, 320): 1.2240, (2, 320, 32, 32, 640): 0.7455,
    (2, 640, 32, 32, 640): 1.4834, (2, 640, 16, 16, 1280): 1.1129,
    (2, 640, 64, 64, 320): 2.4796, (1, 320, 64, 64, 320): 0.7383,
    (1, 320, 32, 32, 640): 0.5476, (1, 640, 32, 32, 640): 1.0913,
    (1, 640, 16, 16, 1280): 0.9942, (1, 640, 64, 64, 320): 1.4686})

# flash forward heads per CTA on the phase-6 path, and the packings phase 2
# holds against K1
HEAD_PACK = 2
K4_PACKS = (2, 4)


def unet_conv3x3_calls(ucfg, batch, side, only=None, itemsize=2):
    """{(B, C, H, W, O): calls} of the resnet 3x3 convs that one UNet call at
    ``side``^2 latents sends to the fused conv (the copied JAX predicate, at
    ``itemsize`` bytes an element: bf16 by default), from the UNet's resnet
    channel map: the conv1 (C_in -> C_out) and conv2 (C_out -> C_out) of
    every ResnetBlock2D (of the one named ``only``, if given)."""
    from diffusion_finetuning_tpu_torch.models.unet import _resnet_channel_map
    from diffusion_finetuning_tpu_torch.ops.conv3x3 import supported

    levels = len(ucfg.block_out_channels)
    calls = {}
    for prefix, cin, cout in _resnet_channel_map(ucfg):
        if only is not None and prefix != only:
            continue
        part = prefix.split("_")
        level = (int(part[2]) if part[0] == "down" else
                 levels - 1 - int(part[2]) if part[0] == "up" else levels - 1)
        hw = side >> level
        for c in (cin, cout):
            if supported((batch, hw, hw, c), (3, 3, c, cout), (1, 1), padding=1,
                         itemsize=itemsize):
                key = (batch, c, hw, hw, cout)
                calls[key] = calls.get(key, 0) + 1
    return calls


def unet_group_norm_calls(ucfg, batch, side):
    """{(B, C, H, W, add, silu): calls} of the GroupNorms of one UNet call
    at ``side``^2 latents: each ResnetBlock2D's norm1 (+SiLU) and norm2
    (time-embedding add, +SiLU), each transformer's norm, conv_norm_out
    (+SiLU)."""
    from diffusion_finetuning_tpu_torch.models.unet import _resnet_channel_map

    levels = len(ucfg.block_out_channels)
    calls = {}

    def add(c, level, has_add, silu):
        hw = side >> level
        key = (batch, c, hw, hw, has_add, silu)
        calls[key] = calls.get(key, 0) + 1

    for prefix, cin, cout in _resnet_channel_map(ucfg):
        part = prefix.split("_")
        level = (int(part[2]) if part[0] == "down" else
                 levels - 1 - int(part[2]) if part[0] == "up" else levels - 1)
        add(cin, level, False, True)
        add(cout, level, True, True)
    chans = list(ucfg.block_out_channels)
    for i, btype in enumerate(ucfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            for _ in range(ucfg.layers_per_block):
                add(chans[i], i, False, False)
    add(chans[-1], levels - 1, False, False)  # the mid block's
    for i, btype in enumerate(ucfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            for _ in range(ucfg.layers_per_block + 1):
                add(chans[levels - 1 - i], levels - 1 - i, False, False)
    add(chans[0], 0, False, True)
    return calls


def vae_decoder_group_norm_calls(vcfg, batch, side):
    """{(B, C, H, W, add, silu): calls} of the GroupNorms of one VAE decode
    of ``side``^2 latents: the mid block's resnets (+SiLU) and attention
    norm, each up block's resnets (+SiLU) at its size, conv_norm_out (+SiLU)."""
    chans = list(reversed(vcfg.block_out_channels))
    calls = {}

    def add(c, hw, silu):
        key = (batch, c, hw, hw, False, silu)
        calls[key] = calls.get(key, 0) + 1

    for _ in range(4):  # two mid resnets' norm1 and norm2
        add(chans[0], side, True)
    add(chans[0], side, False)
    prev, hw = chans[0], side
    for i, ch in enumerate(chans):
        for j in range(vcfg.layers_per_block + 1):
            add(prev if j == 0 else ch, hw, True)
            add(ch, hw, True)
        prev = ch
        if i < len(chans) - 1:
            hw *= 2
    add(chans[-1], hw, True)
    return calls


def request_norms(ucfg, vcfg, unet_calls, encode=False):
    """NHWC GroupNorm calls (``group_norm`` launches) of one generation
    request on the card: each GroupNorm of each of its ``unet_calls`` UNet
    calls, of the VAE decode and, for img2img (``encode``), of the VAE
    encode runs the kernel once, whatever the batch.  The encoder's: two in
    each down block's resnets, four in the mid block's two resnets, its
    attention's, conv_norm_out's."""
    unet = sum(unet_group_norm_calls(ucfg, 1, 8).values())
    decode = sum(vae_decoder_group_norm_calls(vcfg, 1, 8).values())
    encoder = 2 * vcfg.layers_per_block * len(vcfg.block_out_channels) + 4 + 1 + 1
    return unet_calls * unet + decode + (encoder if encode else 0)


def pipe_norms(pipe, unet_calls, encode=False):
    """:func:`request_norms` of ``pipe``'s models."""
    return request_norms(pipe.unet_config, pipe.vae.config, unet_calls, encode)


def check_no_fallbacks(label):
    """No GroupNorm of the generation path so far fell back to PyTorch's
    (``ops/channels_last.py``: only a call that needs a gradient does)."""
    from diffusion_finetuning_tpu_torch.ops import channels_last

    log(f"{label}: channels-last calls so far {channels_last.calls}, GroupNorm fallbacks "
        f"{channels_last.fallbacks} (want 0)")
    if channels_last.fallbacks:
        fail(f"{channels_last.fallbacks} GroupNorms of the generation path ran PyTorch's")


# H100 SXM published dense peaks
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# tolerances (bf16 kernel vs the plain version on the same bf16 inputs:
# rounding of p / h to bf16 and of the output flips at ulp boundaries)
FLASH_TOL = {"max_abs": 2e-2, "rel_l2": 1e-2, "lse_abs": 1e-3}
# fp32 flash forward vs the plain version in fp32: both sum fp32 products in
# fp32 (the kernel's split products drop a 2^-22 term), in a different order,
# so they differ by a few fp32 roundings of O (|O| < 1) and of lse (|lse| <
# 20); a lost or doubled KV tile moves O by 1e-2 or more
FLASH_F32_TOL = {"max_abs": 1e-4, "rel_l2": 1e-5, "lse_abs": 1e-4}
# fp32 LoRA dense, flash backward (each of dQ, dK, dV) and conv3x3 vs their
# plain versions in fp32: max |err| within 1e-4 of the largest reference
# value and rel L2 within 1e-5.  Both sides sum fp32 products in fp32, in
# another order (and the split products drop a 2^-22 term): a few fp32
# roundings of K-term sums (K up to 11520), where a lost k-chunk or tile
# moves the result by 1e-2 or more.  Set on the FMA kernels' first timed run.
LORA_F32_TOL = {"max_rel": 1e-4, "rel_l2": 1e-5}
FLASH_BWD_F32_TOL = {"max_rel": 1e-4, "rel_l2": 1e-5}
CONV_F32_TOL = {"max_rel": 1e-4, "rel_l2": 1e-5}
PEAK_F32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
# H100 SXM dense TF32 on the tensor cores: an fp32 product split into three
# TF32 products (big*big + big*small + small*big) runs at a third of it
PEAK_TF32_FLOPS = 494.7e12
# dQ/dK/dV: max |err| relative to the largest reference value, and rel L2
# (dS rounds to bf16 from sums taken in another order)
FLASH_BWD_TOL = {"max_rel": 2e-2, "rel_l2": 1e-2}
# conv3x3: max |err| within one bf16 ulp of the largest reference value,
# and rel L2 (the 9*C-term fp32 sums run in another order, then both round)
CONV_TOL = {"max_rel": 2 ** -7, "rel_l2": 1e-2}
LORA_TOL = {"max_abs": 5e-2, "rel_l2": 1e-2}
# NHWC GroupNorm vs its plain version on the same inputs: both round one fp32
# value once (bf16: within one bf16 ulp of the largest value; fp32: a few fp32
# roundings), from statistics summed in another order; a lost tile or group
# moves y by its whole scale
GN_TOL = {"max_rel": 2 ** -7, "rel_l2": 1e-3}
GN_F32_TOL = {"max_rel": 1e-5, "rel_l2": 1e-6}
UNET_REL_L2 = 5e-2  # bf16 card run vs fp32 CPU run of the whole UNet
TRAIN_GRAD_REL_L2 = 1e-1  # bf16 card vs fp32 CPU: the whole LoRA gradient of one step


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


_SPIN = {"cycles": 20_000_000, "ms": None}


def _spin_ms():
    """Device ms of one ``torch.cuda._sleep`` of the current cycle count."""
    import torch

    if _SPIN["ms"] is None:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(_SPIN["cycles"])
        b.record()
        b.synchronize()
        _SPIN["ms"] = a.elapsed_time(b)
    return _SPIN["ms"]


def cuda_time(fn, iters, flush=None, hide_host=True):
    """Mean device ms of one fn() call, after a warm-up.

    ``hide_host``: a spin kernel (``torch.cuda._sleep``) holds the card
    while the host enqueues all ``iters`` calls, so that the events time the
    device's work and not Python's launch overhead; if the enqueue outlasts
    the spin, the spin is doubled and the loop run again.  ``flush`` (a
    buffer larger than the 50 MB L2) is rewritten before each call so that
    the inputs come from device memory; the same loop without fn() is timed
    too and subtracted.  Without ``hide_host`` each call is timed alone
    (for the plain versions, whose thousands of launches would fill the
    launch queue)."""
    import torch

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if not hide_host:
        total = 0.0
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            a, b = events()
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters

    def loop(call):
        for _ in range(6):
            spin = _spin_ms()
            a, b = events()
            torch.cuda._sleep(_SPIN["cycles"])
            t0 = time.perf_counter()
            a.record()
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                if call:
                    fn()
            b.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            b.synchronize()
            if host_ms < 0.7 * spin:
                return a.elapsed_time(b)
            _SPIN["cycles"] *= 2
            _SPIN["ms"] = None
        fail("the host cannot enqueue the timed loop while the spin kernel runs")

    base = loop(False) if flush is not None else 0.0
    return max(loop(True) - base, 0.0) / iters


def wall_ms(fn, iters):
    """Mean host-clock ms of fn() ending in a synchronize (a UNet step as
    the serving loop sees it: device time plus any host gaps)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def errors(out, ref):
    o, r = out.float(), ref.float()
    diff = (o - r)
    return float(diff.abs().max()), float(diff.norm() / r.norm().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_build():
    from diffusion_finetuning_tpu_torch.ops import _build

    t0 = time.time()
    logs = _build.build(verbose=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")
    log(f"build: {time.time() - t0:.1f} s ({', '.join(logs) or 'cached'})")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    iters = 30
    results = {}
    log(f"limits, bf16 kernel vs plain version: flash {FLASH_TOL}")

    rows = []
    for sq, skv, d, count in FLASH_SHAPES:
        q, k, v = (torch.randn((FLASH_BH, s, d), generator=gen, device=dev,
                               dtype=torch.bfloat16) for s in (sq, skv, skv))
        scale = d ** -0.5
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, scale, head_pack=1)
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
            torch.cuda.synchronize()
            mx, rel = errors(o, o_ref)
            lse_err = float((lse - lse_ref).abs().max())
            ok = (mx <= FLASH_TOL["max_abs"] and rel <= FLASH_TOL["rel_l2"]
                  and lse_err <= FLASH_TOL["lse_abs"] and bool(torch.isfinite(o).all()))
            ms = cuda_time(lambda: fa._fwd_cuda(q, k, v, scale), iters, flush)
            tile = fa.fwd_q_tile(FLASH_BH, sq)
            other = 64 if tile == 128 else 128  # the tile the rule did not pick
            other_ms = cuda_time(lambda: fa._fwd_cuda(q, k, v, scale, q_tile=other), iters,
                                 flush)
            plain_ms = cuda_time(lambda: fa.flash_attention_plain(q, k, v, scale),
                                 3, flush, hide_host=False)
            q4, k4, v4 = (t.reshape(2, 8, -1, d) for t in (q, k, v))
            lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                               iters, flush)
        flops = 4 * FLASH_BH * sq * skv * d
        nbytes = 2 * FLASH_BH * (2 * sq + 2 * skv) * d + 4 * FLASH_BH * sq
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        by = "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes"
        prev = K1_PREV[1][(sq, skv, d)]
        row = dict(shape=[FLASH_BH, sq, skv, d], per_step=count, max_abs_err=mx,
                   rel_l2=rel, lse_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=by, q_tile=tile,
                   ctas=-(-sq // tile) * FLASH_BH, other_tile_ms=other_ms)
        rows.append(row)
        log(f"flash  BH={FLASH_BH} Sq={sq:5d} Skv={skv:5d} d={d:3d} tile={tile:3d}: "
            f"max_abs={mx:.3e} rel_l2={rel:.3e} lse={lse_err:.2e} "
            f"ms={ms:.4f} (tile {other}: {other_ms:.4f}; {K1_PREV[0]}: {prev:.4f}) "
            f"plain={plain_ms:.3f} sdpa={lib_ms:.4f} "
            f"bound={bound:.4f} ({by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash attention kernel disagrees at {row['shape']}")
    # a ragged fp32 shape (d 40, Sq 200), and K4's fp32 path (K1's fp32 kernel,
    # G heads in turn) equal to K1's
    q, k, v = (torch.randn((4, s, 40), generator=gen, device=dev) for s in (200, 77, 77))
    with torch.inference_mode():
        o, lse = fa._fwd_cuda(q, k, v, 0.2)
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, 0.2)
        o4, lse4 = fa._fwd_cuda(q, k, v, 0.2, 2)
    mx, rel = errors(o, o_ref)
    log(f"flash  fp32 (4, 200, 77, 40): max_abs={mx:.3e} rel_l2={rel:.3e}; "
        f"packed G=2 equal: {torch.equal(o4, o) and torch.equal(lse4, lse)}")
    if not (mx <= 1e-4 and float((lse - lse_ref).abs().max()) <= 1e-4):
        fail("fp32 flash attention kernel disagrees")
    if not (torch.equal(o4, o) and torch.equal(lse4, lse)):
        fail("fp32 packed flash attention kernel differs from the unpacked one")
    results["flash_attention_fwd"] = rows
    results["flash_attention_fwd_packed"] = flash_packed_rows(gen, flush, iters, rows)
    results["flash_attention_bwd"] = flash_bwd_rows(gen, flush, iters)
    results["conv3x3"] = conv3x3_rows(gen, flush, iters)
    results["group_norm"] = group_norm_rows(gen, flush, iters)
    results["lora_dense"] = lora_rows(gen, flush, iters)
    results.update(fp32_rows(gen, flush, iters))
    for name, rows in sd21_rows(gen, flush, iters).items():
        results[name] += rows
    for name, rows in sdxl_rows(gen, flush, iters).items():
        results[name] += rows
    return results


# SD 2.1 at 768^2 (96x96 latents): every transformer block has heads of 64
# (5, 10, 20, 20 heads at widths 320, 640, 1280, 1280), cross-attention over
# 77 OpenCLIP tokens of width 1024.  (BH, Sq, Skv, d, calls) of a CFG UNet
# step (batch 2); a train step runs the same calls at batch 1
SD21_FLASH = []
# (M, K, N, calls) of the LoRA'd projections of a CFG UNet step, as
# LORA_SHAPES; and of a train step (batch 1)
SD21_LORA, SD21_LORA_TRAIN = [], []
for _s, _h, _c, _blocks in ((9216, 5, 320, 5), (2304, 10, 640, 5), (576, 20, 1280, 5),
                            (144, 20, 1280, 1)):
    SD21_FLASH += [(2 * _h, _s, _s, 64, _blocks), (2 * _h, _s, 77, 64, _blocks)]
    for _b, _shapes in ((2, SD21_LORA), (1, SD21_LORA_TRAIN)):
        _shapes += [(_b * _s, _c, _c, 6 * _blocks), (77 * _b, 1024, _c, 2 * _blocks),
                    (_b * _s, _c, 8 * _c, _blocks)]
assert sum(r[4] for r in SD21_FLASH) == FLASH_PER_STEP
assert sum(r[3] for r in SD21_LORA) == sum(r[3] for r in SD21_LORA_TRAIN) == LORA_PER_STEP


def sd21_rows(gen, flush, iters):
    """K1, K3 and K2, bf16 and fp32, at SD 2.1's shapes (phase 12's path):
    rows of their own (``model`` "sd21"; ``per_step`` 0, so the SD1.5 sums
    keep their meaning; ``sd21_per_step`` the calls of a 768^2 CFG UNet
    step, or of a train step for K3, and K2's ``sd21_train_per_step``).
    Each against its plain version within the gate of its SD1.5 rows, a
    second run equal bit for bit; its time beside the plain version's, one
    library call's (SDPA, SDPA's backward, ``addmm`` plus the low-rank
    product) and the bound."""
    import torch

    return model_rows(gen, flush, iters, "sd21", "SD 2.1", SD21_FLASH,
                      (("serve", SD21_LORA, "sd21_per_step"),
                       ("train", SD21_LORA_TRAIN, "sd21_train_per_step")),
                      (torch.bfloat16, torch.float32), backward=True)


def model_rows(gen, flush, iters, model, title, flash, lora, dtypes, backward):
    """K1 (and K3 if ``backward``) at ``flash``'s (BH, Sq, Skv, d, calls)
    and K2 at each ``lora`` set's (M, K, N, calls), in ``dtypes``: rows with
    ``model``, ``per_step`` 0 and the calls under ``{model}_per_step`` (K1,
    K3) or the set's key (K2); see ``sd21_rows``."""
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.ops import flash_attention as fa
    from diffusion_finetuning_tpu_torch.ops import lora_matmul as lm

    dev = torch.device("cuda")
    per_model = f"{model}_per_step"
    out = {name: [] for name in ("flash_attention_fwd", "flash_attention_fwd_fp32",
                                 "flash_attention_bwd", "flash_attention_bwd_fp32",
                                 "lora_dense", "lora_dense_fp32")}

    def finish(name, row, errs_ok, desc):
        row.update(model=model, per_step=0)
        out[name].append(row)
        log(f"{model} {name} {desc}: max_abs={row['max_abs_err']:.3e} "
            f"rel_l2={row['rel_l2']:.3e} "
            f"repeat equal {row['repeat_equal']} ms={row['ms']:.4f} plain={row['plain_ms']:.3f} "
            f"library={row['library_ms']:.4f} bound={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"{'ok' if errs_ok else 'FAIL'}")
        if not errs_ok:
            fail(f"{name} disagrees with its plain version at {title}'s {row['shape']}")

    for dtype in dtypes:
        f32 = dtype == torch.float32
        for bh, sq, skv, d, count in flash:
            q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev, dtype=dtype)
                       for n in (sq, skv, skv))
            with torch.inference_mode():
                o, lse = fa.flash_fwd(q, k, v, d ** -0.5, head_pack=1)
                again = fa.flash_fwd(q, k, v, d ** -0.5, head_pack=1)
                o_ref, lse_ref = fa.flash_attention_plain(q, k, v, d ** -0.5)
                torch.cuda.synchronize()
                mx, rel = errors(o, o_ref)
                lse_err = float((lse - lse_ref).abs().max())
                tol = FLASH_F32_TOL if f32 else FLASH_TOL
                same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
                ok = (same and mx <= tol["max_abs"] and rel <= tol["rel_l2"]
                      and lse_err <= tol["lse_abs"] and bool(torch.isfinite(o).all()))
                ms = cuda_time(lambda: fa._fwd_cuda(q, k, v, d ** -0.5), iters, flush)
                plain_ms = cuda_time(lambda: fa.flash_attention_plain(q, k, v, d ** -0.5), 3,
                                     flush, hide_host=False)
                q4, k4, v4 = (t.reshape(2, bh // 2, -1, d) for t in (q, k, v))
                lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(q4, k4, v4), iters,
                                   flush)
            flops = 4 * bh * sq * skv * d
            nbytes = q.element_size() * bh * (2 * sq + 2 * skv) * d + 4 * bh * sq
            b_ms, by = bound_f32(flops, nbytes)[:2] if f32 else bound(flops, nbytes)
            finish("flash_attention_fwd_fp32" if f32 else "flash_attention_fwd",
                   dict(shape=[bh, sq, skv, d], **{per_model: count}, max_abs_err=mx, rel_l2=rel,
                        lse_abs_err=lse_err, repeat_equal=same, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=b_ms, bound_by=by,
                        q_tile=fa.fwd_q_tile(bh, sq)), ok,
                   f"BH={bh} Sq={sq} Skv={skv} d={d} x{count}")
            del q, k, v, o, lse, again, o_ref, lse_ref, q4, k4, v4
        for bh2, sq, skv, d, count in flash if backward else ():
            bh = bh2 // 2  # a train step: batch 1
            q, k, v, do = (torch.randn((bh, n, d), generator=gen, device=dev, dtype=dtype)
                           for n in (sq, skv, skv, sq))
            with torch.inference_mode():
                o, lse = fa.flash_fwd(q, k, v, d ** -0.5)
                delta = fa._delta(o, do)
                got = fa.flash_bwd(q, k, v, o, lse, do, d ** -0.5)
                again = fa.flash_bwd(q, k, v, o, lse, do, d ** -0.5)
                want = fa.flash_backward_plain(q, k, v, o, lse, do, d ** -0.5)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                errs = [rel_errors(a, b) for a, b in zip(got, want)]
                ok = f32_ok(errs, FLASH_BWD_F32_TOL if f32 else FLASH_BWD_TOL, same,
                            *(bool(torch.isfinite(a).all()) for a in got))
                ms = cuda_time(lambda: fa._bwd_cuda(q, k, v, lse, delta, do, d ** -0.5), iters,
                               flush)
                plain_ms = cuda_time(lambda: fa.flash_backward_plain(q, k, v, o, lse, do,
                                                                     d ** -0.5),
                                     3, flush, hide_host=False)
            q4, k4, v4 = (t.reshape(1, bh, -1, d).detach().requires_grad_(True)
                          for t in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4)
            do4 = do.reshape(1, bh, sq, d)
            lib_ms = cuda_time(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                           retain_graph=True), iters, flush)
            flops = 10 * bh * sq * skv * d
            nbytes = q.element_size() * bh * (3 * sq + 4 * skv) * d + 8 * bh * sq
            b_ms, by = bound_f32(flops, nbytes)[:2] if f32 else bound(flops, nbytes)
            finish("flash_attention_bwd_fp32" if f32 else "flash_attention_bwd",
                   dict(shape=[bh, sq, skv, d], **{per_model: count},
                        max_abs_err=max(e[0] for e in errs), rel_l2=max(e[2] for e in errs),
                        errors={n: dict(max_abs=e[0], max_rel=e[1], rel_l2=e[2])
                                for n, e in zip(("dq", "dk", "dv"), errs)},
                        repeat_equal=same, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=by,
                        q_splits=fa.bwd_q_splits(bh, sq, skv, d,
                                                 fa.bwd_q_rows_f32(d) if f32 else None)),
                   ok, f"BH={bh} Sq={sq} Skv={skv} d={d} x{count} (train step)")
            del q, k, v, do, o, lse, delta, got, again, want, q4, k4, v4, out4
        for kind, shapes, per_set in lora:
            for m, kdim, n, count in shapes:
                x = torch.randn((m, kdim), generator=gen, device=dev).to(dtype)
                w = (torch.randn((n, kdim), generator=gen, device=dev) * kdim ** -0.5).to(dtype)
                b = (torch.randn((n,), generator=gen, device=dev) * 0.1).to(dtype)
                up = (torch.randn((n, LORA_RANK), generator=gen, device=dev) * 0.1).to(dtype)
                down = (torch.randn((LORA_RANK, kdim), generator=gen, device=dev)
                        / LORA_RANK).to(dtype)
                scale = torch.tensor(0.8, device=dev)
                with torch.inference_mode():
                    y = lm.lora_dense(x, w, b, up, down, scale)
                    again = lm.lora_dense(x, w, b, up, down, scale)
                    y_ref = lm.lora_dense_plain(x, w, b, up, down, scale)
                    torch.cuda.synchronize()
                    same = torch.equal(y, again)
                    top = float(y_ref.float().abs().max())
                    if f32:
                        err = rel_errors(y, y_ref)
                        ok = f32_ok([err], LORA_F32_TOL, same, bool(torch.isfinite(y).all()))
                        mx, rel = err[0], err[2]
                    else:
                        mx, rel = errors(y, y_ref)
                        # LORA_TOL's 5e-2 was set at |y| up to 4 (1.6 bf16 ulps
                        # there); the same gate relative to larger outputs
                        top = float(y_ref.float().abs().max())
                        ok = (same and mx <= LORA_TOL["max_abs"] * max(1.0, top / 4)
                              and rel <= LORA_TOL["rel_l2"] and bool(torch.isfinite(y).all()))
                    ms = cuda_time(lambda: lm.lora_dense(x, w, b, up, down, scale), iters,
                                   flush)
                    plain_ms = cuda_time(lambda: lm.lora_dense_plain(x, w, b, up, down, scale),
                                         iters, flush)
                    lib_ms = cuda_time(
                        lambda: torch.addmm(b, x, w.t()).add_((x @ down.t()) @ up.t(),
                                                              alpha=0.8), iters, flush)
                flops = 2 * m * n * kdim + 2 * m * kdim * LORA_RANK + 2 * m * LORA_RANK * n
                nbytes = x.element_size() * (m * kdim + n * kdim + m * n + n + n * LORA_RANK
                                             + LORA_RANK * kdim) + 4
                b_ms, by = bound_f32(flops, nbytes)[:2] if f32 else bound(flops, nbytes)
                plan = lm.plan_f32(m, n, kdim) if f32 else lm.plan(m, n, kdim)
                finish("lora_dense_fp32" if f32 else "lora_dense",
                       dict(shape=[m, kdim, n, LORA_RANK],
                            **{key: count if key == per_set else 0 for _, _, key in lora},
                            max_abs_err=mx, max_abs_ref=top, rel_l2=rel, repeat_equal=same,
                            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                            bound_by=by, plan=list(plan)), ok,
                       f"M={m} K={kdim} N={n} r={LORA_RANK} x{count} {kind} plan {plan}")
                del x, w, b, up, down, y, again, y_ref
    pers = {per_model: "CFG UNet step's"}
    pers.update((key, "train step's" if kind == "train" else
                 "CFG UNet step's" if kind == "serve" else f"{kind}'s") for kind, _, key in lora)
    for name, rows in out.items():
        for per, what in pers.items():
            if any(r.get(per) for r in rows):
                tot = {k: sum(r[k] * r.get(per, 0) for r in rows)
                       for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                what = "train step's" if "bwd" in name else what
                log(f"{model} {name} summed over a {what} "
                    f"calls: {tot['ms']:.4f} ms, library {tot['library_ms']:.4f} "
                    f"(x{tot['ms'] / tot['library_ms']:.3f}), bound {tot['bound_ms']:.4f} "
                    f"(x{tot['ms'] / tot['bound_ms']:.2f}), plain {tot['plain_ms']:.3f}")
    return out


def fp32_rows(gen, flush, iters):
    """The fp32 kernels' rows: K1's forward, K3's pair, K2's and K5's."""
    return {"flash_attention_fwd_fp32": flash_fp32_rows(gen, flush, iters),
            "flash_attention_bwd_fp32": flash_bwd_fp32_rows(gen, flush, iters),
            "lora_dense_fp32": lora_fp32_rows(gen, flush, iters),
            "conv3x3_fp32": conv3x3_fp32_rows(gen, flush, iters)}


def flash_fp32_rows(gen, flush, iters):
    """The fp32 flash forward (``flash_fwd_f32_kernel``) at FLASH_SHAPES,
    BH = 16: an fp32 pipe's 512^2 CFG UNet step, against the plain version
    in fp32 within FLASH_F32_TOL, a second run equal bit for bit; bound of
    the split product (``bound_f32``), the FMA bound in the log."""
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.ops import flash_attention as fa

    log(f"limits, fp32 kernel vs plain version: flash {FLASH_F32_TOL}")
    rows = []
    for sq, skv, d, count in FLASH_SHAPES:
        q, k, v = (torch.randn((FLASH_BH, s, d), generator=gen, device="cuda")
                   for s in (sq, skv, skv))
        scale = d ** -0.5
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, scale, head_pack=1)
            again = fa.flash_fwd(q, k, v, scale, head_pack=1)
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale)
            torch.cuda.synchronize()
            mx, rel = errors(o, o_ref)
            lse_err = float((lse - lse_ref).abs().max())
            same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
            ok = (same and mx <= FLASH_F32_TOL["max_abs"] and rel <= FLASH_F32_TOL["rel_l2"]
                  and lse_err <= FLASH_F32_TOL["lse_abs"] and bool(torch.isfinite(o).all()))
            ms = cuda_time(lambda: fa._fwd_cuda(q, k, v, scale), iters, flush)
            plain_ms = cuda_time(lambda: fa.flash_attention_plain(q, k, v, scale),
                                 3, flush, hide_host=False)
            q4, k4, v4 = (t.reshape(2, 8, -1, d) for t in (q, k, v))
            lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                               iters, flush)
        bound, by, fma = bound_f32(4 * FLASH_BH * sq * skv * d,
                                   4 * FLASH_BH * (2 * sq + 2 * skv) * d + 4 * FLASH_BH * sq)
        row = dict(shape=[FLASH_BH, sq, skv, d], per_step=count, max_abs_err=mx,
                   rel_l2=rel, lse_abs_err=lse_err, repeat_equal=same, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                   fma_bound_ms=fma)
        rows.append(row)
        log(f"flash fp32 BH={FLASH_BH} Sq={sq:5d} Skv={skv:5d} d={d:3d}: "
            f"max_abs={mx:.3e} rel_l2={rel:.3e} lse={lse_err:.2e} repeat equal {same} "
            f"ms={ms:.4f} plain={plain_ms:.3f} sdpa={lib_ms:.4f} bound={bound:.4f} ({by}; "
            f"FMA bound {fma:.4f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"fp32 flash attention kernel disagrees at {row['shape']}")
        del q, k, v, o, o_ref, lse, lse_ref, again
    step_sums(rows, "flash fp32 over a CFG UNet step's calls", "sdpa")
    return rows


def rel_errors(out, ref):
    """(max |err|, max |err| / max |ref|, rel L2)."""
    mx, rel = errors(out, ref)
    return mx, mx / max(float(ref.float().abs().max()), 1e-30), rel


def f32_ok(errs, tol, *flags):
    """Every (max |err|, max relative, rel L2) within ``tol`` and every flag
    true."""
    return all(flags) and all(r <= tol["max_rel"] and l2 <= tol["rel_l2"]
                              for _, r, l2 in errs)


def flash_bwd_fp32_rows(gen, flush, iters):
    """K3's fp32 pair (``flash_bwd_f32_kernel`` and
    ``flash_bwd_dq_f32_kernel``) at FLASH_SHAPES, BH = FLASH_BWD_BH (an fp32
    train step at batch 1), O and lse from the fp32 forward: dQ, dK and dV
    against the plain version in fp32 within FLASH_BWD_F32_TOL, all three
    repeating bit for bit; its time beside the plain version's, SDPA's
    backward alone in fp32 and both bounds (``bound_f32``)."""
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    bh = FLASH_BWD_BH
    log(f"limits, flash backward fp32 kernel vs plain version: {FLASH_BWD_F32_TOL}")
    rows = []
    for sq, skv, d, count in FLASH_SHAPES:
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device=dev)
                       for s in (sq, skv, skv, sq))
        scale = d ** -0.5
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, scale)
            delta = fa._delta(o, do)
            got = fa.flash_bwd(q, k, v, o, lse, do, scale)
            again = fa.flash_bwd(q, k, v, o, lse, do, scale)
            want = fa.flash_backward_plain(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            errs = [rel_errors(a, b) for a, b in zip(got, want)]
            ok = f32_ok(errs, FLASH_BWD_F32_TOL, same,
                        *(bool(torch.isfinite(a).all()) for a in got))
            ms = cuda_time(lambda: fa._bwd_cuda(q, k, v, lse, delta, do, scale), iters, flush)
            plain_ms = cuda_time(lambda: fa.flash_backward_plain(q, k, v, o, lse, do, scale),
                                 3, flush, hide_host=False)
        q4, k4, v4 = (t.reshape(1, bh, -1, d).detach().requires_grad_(True) for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4)
        do4 = do.reshape(1, bh, sq, d)
        lib_ms = cuda_time(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                       retain_graph=True), iters, flush)
        bound, by, fma = bound_f32(10 * bh * sq * skv * d,
                                   4 * bh * (3 * sq + 4 * skv) * d + 8 * bh * sq)
        row = dict(shape=[bh, sq, skv, d], per_step=count,
                   max_abs_err=max(e[0] for e in errs), rel_l2=max(e[2] for e in errs),
                   errors={n: dict(max_abs=e[0], max_rel=e[1], rel_l2=e[2])
                           for n, e in zip(("dq", "dk", "dv"), errs)},
                   repeat_equal=same, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound, bound_by=by, fma_bound_ms=fma)
        rows.append(row)
        log(f"flash bwd fp32 BH={bh} Sq={sq:5d} Skv={skv:5d} d={d:3d}: "
            + " ".join(f"{n} max_rel={e[1]:.2e} rel_l2={e[2]:.2e}"
                       for n, e in zip(("dq", "dk", "dv"), errs))
            + f" repeat equal {same} ms={ms:.4f} plain={plain_ms:.3f} sdpa_bwd={lib_ms:.4f} "
            f"bound={bound:.4f} ({by}; FMA bound {fma:.4f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"fp32 flash attention backward kernel disagrees at {row['shape']}")
        del q, k, v, do, o, lse, delta, got, again, want, q4, k4, v4, out4
    step_sums(rows, "flash bwd fp32 over a train step's calls", "sdpa_bwd")
    return rows


def lora_fp32_rows(gen, flush, iters):
    """K2's fp32 kernel (``lora_dense_tf32_kernel``, the split product) at
    every LoRA'd projection of a CFG UNet step and of a train step, and at
    the text encoder's (TEXT_LORA_ROW: an fp32 DreamBooth step's 154 prompt
    rows, 48 calls), rank 4, fp32, at ``lora_matmul.plan_f32``'s grid:
    against the plain version in fp32 within LORA_F32_TOL, a second run
    equal bit for bit; its time beside the choices its rules did not make
    (W split by the other route, ``lora_matmul.f32_w_in_smem``; the other
    tiles unsplit, half and twice the splits), the FMA kernel's
    (``K2F32_PREV``, log only), the plain version's, the library route in
    fp32 (``addmm`` plus the low-rank product), ``F.linear`` alone and both
    bounds (``bound_f32``)."""
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.ops import _grid
    from diffusion_finetuning_tpu_torch.ops import lora_matmul as lm

    dev = torch.device("cuda")
    log(f"limits, lora fp32 kernel vs plain version: {LORA_F32_TOL}")
    rows = []
    for kind, shapes in (("serve", LORA_SHAPES), ("train", LORA_TRAIN_SHAPES),
                         ("text", [TEXT_LORA_ROW])):
        for m, kdim, n, count in shapes:
            x = torch.randn((m, kdim), generator=gen, device=dev)
            w = torch.randn((n, kdim), generator=gen, device=dev) * kdim ** -0.5
            b = torch.randn((n,), generator=gen, device=dev) * 0.1
            up = torch.randn((n, LORA_RANK), generator=gen, device=dev) * 0.1
            down = torch.randn((LORA_RANK, kdim), generator=gen, device=dev) / LORA_RANK
            scale = torch.tensor(0.8, device=dev)
            grid = lm.plan_f32(m, n, kdim)
            bm, bn, splits = grid
            w_smem = lm.f32_w_in_smem(m, kdim, bm)
            steps = -(-kdim // lm.K_STEP_F32)
            others = sorted(({(tm, tn, 1) for tm, tn in lm.TILES if tm <= -(-m // 64) * 64}
                             | {(bm, bn, max(1, splits // 2)), (bm, bn, min(steps, 2 * splits))})
                            - {grid})
            with torch.inference_mode():
                y = lm.lora_dense(x, w, b, up, down, scale)
                again = lm.lora_dense(x, w, b, up, down, scale)
                y_ref = lm.lora_dense_plain(x, w, b, up, down, scale)
                torch.cuda.synchronize()
                err = rel_errors(y, y_ref)
                same = torch.equal(y, again)
                ok = f32_ok([err], LORA_F32_TOL, same, bool(torch.isfinite(y).all()))
                ms = cuda_time(lambda: lm.lora_dense(x, w, b, up, down, scale), iters, flush)
                other_w_ms = cuda_time(lambda: lm._lora_dense_cuda(
                    x, w, b, up, down, scale, w_split=not w_smem), iters, flush)
                other_ms = {g: cuda_time(lambda: lm._lora_dense_cuda(
                    x, w, b, up, down, scale, grid=g), iters, flush) for g in others}
                plain_ms = cuda_time(lambda: lm.lora_dense_plain(x, w, b, up, down, scale),
                                     iters, flush)
                lib_ms = cuda_time(
                    lambda: torch.addmm(b, x, w.t()).add_((x @ down.t()) @ up.t(),
                                                          alpha=0.8),
                    iters, flush)
                linear_ms = cuda_time(lambda: F.linear(x, w, b), iters, flush)
            bound, by, fma = bound_f32(
                2 * m * n * kdim + 2 * m * kdim * LORA_RANK + 2 * m * LORA_RANK * n,
                4 * (m * kdim + n * kdim + m * n + n + n * LORA_RANK + LORA_RANK * kdim) + 4)
            ctas = _grid.cdiv(m, bm) * _grid.cdiv(n, bn) * splits
            row = dict(shape=[m, kdim, n, LORA_RANK], per_step=count if kind == "serve" else 0,
                       train_per_step=count if kind == "train" else 0,
                       text_per_step=count if kind == "text" else 0, max_abs_err=err[0],
                       max_rel_err=err[1], rel_l2=err[2], repeat_equal=same, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, linear_ms=linear_ms,
                       bound_ms=bound, bound_by=by, fma_bound_ms=fma, plan=list(grid),
                       ctas=ctas, w_in_smem=w_smem, other_w_route_ms=other_w_ms,
                       other_plans_ms={str(list(g)): t for g, t in other_ms.items()})
            rows.append(row)
            prev = K2F32_PREV[1].get((m, kdim, n))
            log(f"lora fp32 M={m:5d} K={kdim:5d} N={n:6d} r={LORA_RANK} x{count:2d} {kind} "
                f"plan bm={bm} bn={bn} splits={splits} ({ctas} CTAs), W "
                f"{'in shared memory' if w_smem else 'by the prep pass'}: "
                f"max_rel={err[1]:.2e} rel_l2={err[2]:.2e} repeat equal {same} ms={ms:.4f} ("
                f"W by the other route: {other_w_ms:.4f}; "
                + "".join(f"{list(g)}: {t:.4f}; " for g, t in other_ms.items())
                + (f"{K2F32_PREV[0]}: {prev:.4f}" if prev is not None else "no earlier time")
                + f") plain={plain_ms:.4f} addmm+lowrank={lib_ms:.4f} linear={linear_ms:.4f} "
                f"bound={bound:.4f} ({by}; FMA bound {fma:.4f}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"fp32 LoRA dense kernel disagrees at {row['shape']}")
            del x, w, b, up, down, y, again, y_ref
    step_sums(rows, "lora fp32 over a CFG UNet step's calls", "addmm+lowrank")
    step_sums(rows, "lora fp32 over a train step's calls", "addmm+lowrank",
              per="train_per_step")
    # an fp32 DreamBooth step at batch 2 (prior preservation) runs the UNet's
    # projections at the CFG step's shapes and the text encoder's 48
    for r in rows:
        r["dreambooth_per_step"] = r["per_step"] + r["text_per_step"]
    step_sums(rows, "lora fp32 over an fp32 DreamBooth step's forward calls", "addmm+lowrank",
              per="dreambooth_per_step")
    prev = {key: sum(K2F32_PREV[1][tuple(r["shape"][:3])] * r[per] for r in rows
                     if tuple(r["shape"][:3]) in K2F32_PREV[1])
            for key, per in (("CFG UNet step", "per_step"), ("train step", "train_per_step"))}
    log(f"lora fp32, {K2F32_PREV[0]}: {prev['CFG UNet step']:.4f} ms a CFG UNet step, "
        f"{prev['train step']:.4f} ms a train step")
    for per in ("per_step", "train_per_step"):
        route = {smem: sum((r["ms"] if r["w_in_smem"] == smem else r["other_w_route_ms"])
                           * r[per] for r in rows) for smem in (False, True)}
        log(f"lora fp32 W routes over a {'CFG UNet' if per == 'per_step' else 'train'} step: "
            f"prep pass everywhere {route[False]:.4f} ms, shared memory everywhere "
            f"{route[True]:.4f} ms, by shape {sum(r['ms'] * r[per] for r in rows):.4f} ms")
    return rows


def conv3x3_fp32_rows(gen, flush, iters):
    """K5's fp32 kernel (``conv3x3_tf32_kernel``, the split product) at every
    SD1.5 resnet conv shape the routing sends it at 512^2 in fp32, batch 2
    and 1, no bias, at ``conv3x3.plan_f32``'s grid: against the plain
    version in fp32 within CONV_F32_TOL, a second run equal bit for bit; its
    time beside the splits its rule did not pick (1-4, among them the one
    ``_grid.k_splits`` would), the FMA kernel's (``K5F32_PREV``, log only),
    the plain version's, cuDNN's in fp32 (``F.conv2d``, TF32 off) and both
    bounds (``bound_f32``).  The split tap-major weight copy is made before the
    timings, as the layers' frozen weights have it after their first call."""
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig
    from diffusion_finetuning_tpu_torch.ops import _grid
    from diffusion_finetuning_tpu_torch.ops import conv3x3 as cv

    dev = torch.device("cuda")
    side = IMAGE // 8
    log(f"limits, conv3x3 fp32 kernel vs plain version: {CONV_F32_TOL}")
    rows = []
    for batch in (2, 1):
        for (b, c, h, w, o), calls in unet_conv3x3_calls(UNetConfig.sd15(), batch, side,
                                                         itemsize=4).items():
            x = torch.randn((b, c, h, w), generator=gen, device=dev)
            wt = torch.randn((o, c, 3, 3), generator=gen, device=dev) / (3 * c ** 0.5)
            p = cv.plan_f32(b, c, h, w, o)
            steps = 9 * -(-cv.f32_channels(c) // cv.C_STEP_F32)
            k_rule = _grid.k_splits(p.tiles, steps, 4)
            others = sorted({1, 2, 3, 4, k_rule} - {p.splits})
            with torch.inference_mode():
                y = cv._conv3x3_cuda(x, wt, None)
                again = cv._conv3x3_cuda(x, wt, None)
                y_ref = cv.conv3x3_plain(x, wt, None)
                torch.cuda.synchronize()
                err = rel_errors(y, y_ref)
                same = torch.equal(y, again)
                ok = f32_ok([err], CONV_F32_TOL, same, bool(torch.isfinite(y).all()))
                ms = cuda_time(lambda: cv._conv3x3_cuda(x, wt, None), iters, flush)
                other_ms = {sp: cuda_time(lambda: cv._conv3x3_cuda(
                    x, wt, None, grid=cv.plan_f32(b, c, h, w, o, splits=sp)), iters, flush)
                    for sp in others}
                plain_ms = cuda_time(lambda: cv.conv3x3_plain(x, wt, None), 3, flush,
                                     hide_host=False)
                lib_ms = cuda_time(lambda: F.conv2d(x, wt, None, padding=1), iters, flush)
            bound, by, fma = bound_f32(2 * b * h * w * c * o * 9,
                                       4 * (b * c * h * w + o * c * 9 + b * o * h * w))
            row = dict(shape=[b, c, h, w, o], per_step=calls if batch == 2 else 0,
                       train_per_step=calls if batch == 1 else 0, max_abs_err=err[0],
                       max_rel_err=err[1], rel_l2=err[2], repeat_equal=same, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                       fma_bound_ms=fma, plan=p._asdict(), ctas=p.tiles * p.splits,
                       k_splits_rule_ms=other_ms.get(k_rule, ms),
                       other_plans_ms={f"splits={sp}": t for sp, t in other_ms.items()})
            rows.append(row)
            prev = K5F32_PREV[1].get((b, c, h, w, o))
            log(f"conv3x3 fp32 B={b} C={c:4d} {h:2d}x{w:2d} O={o:4d} x{calls:2d} plan "
                f"box={p.box} rows={p.rows} splits={p.splits} ({p.tiles * p.splits} CTAs; "
                f"k_splits would take {k_rule}): "
                f"max_rel={err[1]:.2e} rel_l2={err[2]:.2e} repeat equal {same} ms={ms:.4f} ("
                + "".join(f"splits={sp}: {t:.4f}; " for sp, t in other_ms.items())
                + (f"{K5F32_PREV[0]}: {prev:.4f}" if prev is not None else "no earlier time")
                + f") plain={plain_ms:.3f} cudnn={lib_ms:.4f} bound={bound:.4f} ({by}; FMA "
                f"bound {fma:.4f}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"fp32 conv3x3 kernel disagrees at {row['shape']}")
            del x, wt, y, again, y_ref
    step_sums(rows, "conv3x3 fp32 over a CFG UNet step's calls", "cudnn")
    before = sum(K5F32_PREV[1][tuple(r["shape"])] * r["per_step"] for r in rows)
    k_rule = sum(r["k_splits_rule_ms"] * r["per_step"] for r in rows)
    log(f"conv3x3 fp32, {K5F32_PREV[0]}: {before:.4f} ms a CFG UNet step; at the splits "
        f"_grid.k_splits would take: {k_rule:.4f} ms")
    return rows


def step_sums(rows, label, lib_name, per="per_step"):
    """Log an fp32 row's times summed over one step's calls (each shape's
    time x its calls ``per`` step): the kernel, its library call and both
    bounds."""
    total = {key: sum(r[key] * r[per] for r in rows)
             for key in ("ms", "library_ms", "bound_ms", "fma_bound_ms")}
    log(f"{label}: {total['ms']:.4f} ms, {lib_name} {total['library_ms']:.4f} ms "
        f"(kernel x{total['ms'] / total['library_ms']:.3f}), bound {total['bound_ms']:.4f} ms "
        f"(x{total['ms'] / total['bound_ms']:.2f}), FMA bound {total['fma_bound_ms']:.4f} ms")


def lora_rows(gen, flush, iters):
    """K2 at every LoRA'd projection of a CFG UNet step (serving, batch 2:
    ``per_step``) and of a train step (batch 1: ``train_per_step``), rank 4:
    error against the plain version on the same bf16 inputs, its time
    beside the plans its rule did not pick (the other tiles of
    ``lora_matmul.TILES``; half and twice the splits) and beside its first
    design (``K2_PREV``, log only), the
    plain version's time, the library route (``addmm`` plus the low-rank
    product: the same function in three calls) and ``F.linear`` alone (the
    floor of any library route), and the bound."""
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.ops import _grid
    from diffusion_finetuning_tpu_torch.ops import lora_matmul as lm

    dev = torch.device("cuda")
    log(f"limits, lora bf16 kernel vs plain version: {LORA_TOL}")
    rows = []
    for batch, shapes in ((2, LORA_SHAPES), (1, LORA_TRAIN_SHAPES)):
        for m, kdim, n, count in shapes:
            x = torch.randn((m, kdim), generator=gen, device=dev, dtype=torch.bfloat16)
            w = (torch.randn((n, kdim), generator=gen, device=dev) * kdim ** -0.5).bfloat16()
            b = (torch.randn((n,), generator=gen, device=dev) * 0.1).bfloat16()
            up = (torch.randn((n, LORA_RANK), generator=gen, device=dev) * 0.1).bfloat16()
            down = (torch.randn((LORA_RANK, kdim), generator=gen, device=dev)
                    / LORA_RANK).bfloat16()
            scale = torch.tensor(0.8, device=dev)
            grid = lm.plan(m, n, kdim)
            bm, bn, splits = grid
            steps = -(-kdim // lm.K_STEP)
            others = sorted(({(tm, tn, splits) for tm, tn in lm.TILES}
                             | {(bm, bn, max(1, splits // 2)), (bm, bn, min(steps, 2 * splits))})
                            - {grid})
            with torch.inference_mode():
                y = lm.lora_dense(x, w, b, up, down, scale)
                again = lm.lora_dense(x, w, b, up, down, scale)
                y_ref = lm.lora_dense_plain(x, w, b, up, down, scale)
                torch.cuda.synchronize()
                mx, rel = errors(y, y_ref)
                same = torch.equal(y, again)
                ok = (same and mx <= LORA_TOL["max_abs"] and rel <= LORA_TOL["rel_l2"]
                      and bool(torch.isfinite(y).all()))
                ms = cuda_time(lambda: lm.lora_dense(x, w, b, up, down, scale), iters, flush)
                other_ms = {g: cuda_time(lambda: lm._lora_dense_cuda(x, w, b, up, down, scale,
                                                                     grid=g), iters, flush)
                            for g in others}
                plain_ms = cuda_time(lambda: lm.lora_dense_plain(x, w, b, up, down, scale),
                                     iters, flush)
                lib_ms = cuda_time(
                    lambda: torch.addmm(b, x, w.t()).add_((x @ down.t()) @ up.t(),
                                                          alpha=0.8),
                    iters, flush)
                linear_ms = cuda_time(lambda: F.linear(x, w, b), iters, flush)
            bound_ms, by = bound(
                2 * m * n * kdim + 2 * m * kdim * LORA_RANK + 2 * m * LORA_RANK * n,
                2 * (m * kdim + n * kdim + m * n + n + n * LORA_RANK + LORA_RANK * kdim) + 4)
            ctas = _grid.cdiv(m, bm) * _grid.cdiv(n, bn) * splits
            row = dict(shape=[m, kdim, n, LORA_RANK], per_step=count if batch == 2 else 0,
                       train_per_step=count if batch == 1 else 0, max_abs_err=mx,
                       rel_l2=rel, repeat_equal=same, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, linear_ms=linear_ms, bound_ms=bound_ms,
                       bound_by=by, plan=list(grid), ctas=ctas,
                       other_plans_ms={str(list(g)): t for g, t in other_ms.items()})
            rows.append(row)
            prev = K2_PREV[1].get((m, kdim, n))
            log(f"lora   M={m:5d} K={kdim:5d} N={n:6d} r={LORA_RANK} x{count:2d} "
                f"{'serve' if batch == 2 else 'train'} plan bm={bm} bn={bn} splits={splits} "
                f"({ctas} CTAs): max_abs={mx:.3e} rel_l2={rel:.3e} repeat equal {same} "
                f"ms={ms:.4f} ("
                + "".join(f"{list(g)}: {t:.4f}; " for g, t in other_ms.items())
                + (f"{K2_PREV[0]}: {prev:.4f}" if prev is not None else "no earlier time")
                + f") plain={plain_ms:.4f} addmm+lowrank={lib_ms:.4f} linear={linear_ms:.4f} "
                f"bound={bound_ms:.4f} ({by}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"LoRA dense kernel disagrees at {row['shape']}")
    x = torch.randn((100, 72), generator=gen, device=dev)
    w, up, down = (torch.randn(s, generator=gen, device=dev) * 0.2
                   for s in ((90, 72), (90, 3), (3, 72)))
    with torch.inference_mode():
        mx, rel = errors(lm.lora_dense(x, w, None, up, down, 0.5),
                         lm.lora_dense_plain(x, w, None, up, down, 0.5))
    log(f"lora   fp32 (100, 72, 90, r=3): max_abs={mx:.3e} rel_l2={rel:.3e}")
    if mx > 1e-4:
        fail("fp32 LoRA dense kernel disagrees")
    return rows


def bound(flops, nbytes):
    """(bound ms, what bounds it) on the H100's published peaks."""
    by = "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes"
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3, by


def bound_f32(flops, nbytes):
    """(bound ms, what bounds it, FMA bound ms) of fp32 work: the least
    time of the split product, 3 TF32 products a product on the tensor
    cores, against the bytes; beside it the bound at the fp32 rate outside
    the tensor cores (the ceiling of a kernel on the FMA units, kept for the
    log)."""
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    fma = max(flops / PEAK_F32_FLOPS, t_bytes) * 1e3
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes", fma


def flash_packed_rows(gen, flush, iters, k1_rows):
    """K4 at G = 2 and 4 at every serving flash shape (BH = 16): O and lse
    equal to K1's bit for bit, error against the packed plain version, its
    time at the tile of ``packed_q_tile`` beside the tile the rule did not
    pick, beside K1's time in this run (``k1_rows``) and the parent design's
    (``K4_PREV``, log only), the plain version's, SDPA's, and the bound
    (K1's: the same work).  Rows of G = HEAD_PACK carry the calls a phase-6
    UNet step makes; the others count 0."""
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    k1_ms = {tuple(r["shape"]): r["ms"] for r in k1_rows}
    log(f"limits, packed flash: O and lse equal to K1's; vs plain version {FLASH_TOL}")
    rows = []
    for pack in K4_PACKS:
        for sq, skv, d, count in FLASH_SHAPES:
            q, k, v = (torch.randn((FLASH_BH, s, d), generator=gen, device=dev,
                                   dtype=torch.bfloat16) for s in (sq, skv, skv))
            scale = d ** -0.5
            tile = fa.packed_q_tile(FLASH_BH, pack, sq)
            other = 64 if tile == 128 else 128  # the tile the rule did not pick
            with torch.inference_mode():
                o1, lse1 = fa._fwd_cuda(q, k, v, scale)
                o, lse = fa._fwd_cuda(q, k, v, scale, pack)
                o2, lse2 = fa._fwd_cuda(q, k, v, scale, pack, q_tile=other)
                o_ref, lse_ref = fa.flash_attention_plain_packed(q, k, v, scale, pack)
                torch.cuda.synchronize()
                equal = all(torch.equal(a, b) for a, b in ((o, o1), (lse, lse1), (o2, o1),
                                                           (lse2, lse1)))
                mx, rel = errors(o, o_ref)
                lse_err = float((lse - lse_ref).abs().max())
                ok = (equal and mx <= FLASH_TOL["max_abs"] and rel <= FLASH_TOL["rel_l2"]
                      and lse_err <= FLASH_TOL["lse_abs"])
                ms = cuda_time(lambda: fa._fwd_cuda(q, k, v, scale, pack), iters, flush)
                other_ms = cuda_time(lambda: fa._fwd_cuda(q, k, v, scale, pack, q_tile=other),
                                     iters, flush)
                plain_ms = cuda_time(
                    lambda: fa.flash_attention_plain_packed(q, k, v, scale, pack),
                    3, flush, hide_host=False)
                q4, k4, v4 = (t.reshape(2, 8, -1, d) for t in (q, k, v))
                lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                                   iters, flush)
            routed = fa.use_head_pack(pack, FLASH_BH, sq, skv, d, 2)
            bound_ms, by = bound(4 * FLASH_BH * sq * skv * d,
                                 2 * FLASH_BH * (2 * sq + 2 * skv) * d + 4 * FLASH_BH * sq)
            k1 = k1_ms[(FLASH_BH, sq, skv, d)]
            prev = K4_PREV[1][(pack, sq, skv, d)]
            row = dict(shape=[FLASH_BH, sq, skv, d], head_pack=pack, routed=routed,
                       q_tile=tile, ctas=-(-sq // tile) * (FLASH_BH // pack),
                       per_step=count if pack == HEAD_PACK and routed else 0,
                       calls_per_step=count, equal_to_k1=equal, max_abs_err=mx, rel_l2=rel,
                       lse_abs_err=lse_err, ms=ms, other_tile_ms=other_ms, k1_ms=k1,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by)
            rows.append(row)
            log(f"flash packed G={pack} BH={FLASH_BH} Sq={sq:5d} Skv={skv:5d} d={d:3d} "
                f"tile={tile:3d} ({row['ctas']} CTAs): equal to K1 {equal}, "
                f"max_abs={mx:.3e} lse={lse_err:.2e} ms={ms:.4f} (tile {other}: "
                f"{other_ms:.4f}; K1 {k1:.4f}, x{ms / k1:.3f}; {K4_PREV[0]}: {prev:.4f}) "
                f"plain={plain_ms:.3f} sdpa={lib_ms:.4f} bound={bound_ms:.4f} ({by}) "
                f"routed={routed} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"packed flash attention kernel disagrees at G={pack} {row['shape']}")
    for pack in K4_PACKS:
        mine = [r for r in rows if r["head_pack"] == pack]
        ours = sum(r["ms"] * r["calls_per_step"] for r in mine)
        k1 = sum(r["k1_ms"] * r["calls_per_step"] for r in mine)
        prev = sum(K4_PREV[1][(pack, *r["shape"][1:])] * r["calls_per_step"] for r in mine)
        log(f"flash packed G={pack}, summed over a CFG UNet step's calls: {ours:.4f} ms "
            f"(K1 {k1:.4f}, x{ours / k1:.3f}; {K4_PREV[0]}: {prev:.4f})")
    return rows


def conv3x3_rows(gen, flush, iters):
    """K5 at every distinct SD1.5 resnet conv shape the routing sends it at
    512^2, batch 2 (a CFG UNet step) and batch 1 (a train step), without a
    bias as the layers call it: error against the plain version on the same
    bf16 inputs, a second run equal bit for bit, its time beside the plans
    its rule did not pick (half and twice the splits) and beside its first
    design (``K5_PREV``, log only), the plain
    version's time, cuDNN's (``F.conv2d``), and the bound (2*B*H*W*C*O*9
    operations; x, weight and y bytes).  The tap-major weight copy is made
    before the timings, as the layers' frozen weights have it after their
    first call."""
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig
    from diffusion_finetuning_tpu_torch.ops import conv3x3 as cv

    dev = torch.device("cuda")
    side = IMAGE // 8
    log(f"limits, conv3x3 bf16 kernel vs plain version: {CONV_TOL}")
    rows = []
    w9_bytes = 0
    for batch in (2, 1):
        for (b, c, h, w, o), calls in unet_conv3x3_calls(UNetConfig.sd15(), batch, side).items():
            x = torch.randn((b, c, h, w), generator=gen, device=dev, dtype=torch.bfloat16)
            wt = (torch.randn((o, c, 3, 3), generator=gen, device=dev)
                  / (3 * c ** 0.5)).bfloat16()
            p = cv.plan(b, c, h, w, o)
            steps = 9 * -(-c // cv.C_STEP)
            others = sorted({max(1, p.splits // 2), min(steps, 2 * p.splits)} - {p.splits})
            with torch.inference_mode():
                y = cv._conv3x3_cuda(x, wt, None)
                again = cv._conv3x3_cuda(x, wt, None)
                y_ref = cv.conv3x3_plain(x, wt, None)
                torch.cuda.synchronize()
                mx, rel = errors(y, y_ref)
                peak = float(y_ref.float().abs().max())
                same = torch.equal(y, again)
                ok = (same and mx <= CONV_TOL["max_rel"] * peak and rel <= CONV_TOL["rel_l2"]
                      and bool(torch.isfinite(y).all()))
                ms = cuda_time(lambda: cv._conv3x3_cuda(x, wt, None), iters, flush)
                other_ms = {g: cuda_time(lambda: cv._conv3x3_cuda(
                    x, wt, None, grid=cv.plan(b, c, h, w, o, splits=g)),
                    iters, flush) for g in others}
                plain_ms = cuda_time(lambda: cv.conv3x3_plain(x, wt, None), 3, flush,
                                     hide_host=False)
                lib_ms = cuda_time(lambda: F.conv2d(x, wt, None, padding=1), iters, flush)
            if batch == 2:
                w9_bytes += calls * 2 * 9 * o * c  # one copy per routed conv of the UNet
            bound_ms, by = bound(2 * b * h * w * c * o * 9,
                                 2 * (b * c * h * w + o * c * 9 + b * o * h * w))
            ctas = p.tiles * p.splits
            row = dict(shape=[b, c, h, w, o], per_step=calls if batch == 2 else 0,
                       train_per_step=calls if batch == 1 else 0, max_abs_err=mx,
                       max_rel_err=mx / peak, rel_l2=rel, repeat_equal=same, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                       plan=p._asdict(), ctas=ctas,
                       other_plans_ms={f"splits={g}": t
                                       for g, t in other_ms.items()})
            rows.append(row)
            log(f"conv3x3 B={b} C={c:4d} {h:2d}x{w:2d} O={o:4d} x{calls:2d} plan sw={p.sw} "
                f"rows={p.rows} splits={p.splits} ({ctas} CTAs): max_abs={mx:.3e} "
                f"rel_l2={rel:.3e} repeat equal {same} ms={ms:.4f} ("
                + "".join(f"splits={g}: {t:.4f}; " for g, t in other_ms.items())
                + (f"{K5_PREV[0]}: {K5_PREV[1][(b, c, h, w, o)]:.4f}"
                   if (b, c, h, w, o) in K5_PREV[1] else "no earlier time")
                + f") plain={plain_ms:.3f} "
                f"cudnn={lib_ms:.4f} bound={bound_ms:.4f} ({by}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"conv3x3 kernel disagrees at {row['shape']}")
    log(f"conv3x3 tap-major weight copies of one UNet's routed convs: {w9_bytes} bytes")
    # fp32 inputs take the split-product kernel at every shape: check it once,
    # ragged (W = 11, C = 24, O = 70, a bias)
    x = torch.randn((2, 24, 9, 11), generator=gen, device=dev)
    wt = torch.randn((70, 24, 3, 3), generator=gen, device=dev) * 0.1
    bias = torch.randn((70,), generator=gen, device=dev)
    with torch.inference_mode():
        _, rel = errors(cv._conv3x3_cuda(x, wt, bias), cv.conv3x3_plain(x, wt, bias))
    log(f"conv3x3 fp32 (2, 24, 9x11, 70): rel_l2={rel:.3e}")
    if not rel <= 1e-5:
        fail("fp32 conv3x3 kernel disagrees")
    return rows


GN_SETS = (  # (label, per-call key of the row, model, batch, latent side)
    ("sd15 UNet, 512^2 CFG batch 2", "per_step", "sd15", 2, 64),
    ("sd21 UNet, 768^2 batch 8 (4 images, CFG)", "sd21_per_step", "sd21", 8, 96),
    ("VAE decode, 768^2 batch 4", "vae_per_decode", "vae", 4, 96),
)
# SDXL's (phase 13's path) at the batch cell sdxl_base.serve.batch_lora serves
SDXL_GN_SETS = (
    ("sdxl UNet, 1024^2 batch 8 (4 images, CFG)", "sdxl_per_step", "sdxl", 8, 128),
    ("sdxl VAE decode, 1024^2 batch 4", "sdxl_vae_per_decode", "sdxl_vae", 4, 128),
)


def group_norm_rows(gen, flush, iters, sets=GN_SETS, fp32=True):
    """The NHWC GroupNorm (``ops/group_norm.py``, no TPU counterpart) at
    every distinct GroupNorm shape of ``sets`` (by default an SD1.5 512^2
    CFG UNet step (batch 2), an SD 2.1 768^2 UNet step at batch 8 and a
    768^2 VAE decode of 4 images), bf16 channels-last, with the resnets' add and SiLU where they
    take them: error against the plain version, a second run equal bit for
    bit, its time, the plain version's, PyTorch's GroupNorm (+ add, + SiLU)
    on the NCHW tensor as the modules ran before (``library_ms``, never
    called by the port) and the bound (x read and y written once, 3.35
    TB/s).  Then, if ``fp32``, once in fp32.  ``per_step`` holds the SD1.5
    step's calls, the set's key (``sd21_per_step``, ``vae_per_decode``, ...)
    the others'."""
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig
    from diffusion_finetuning_tpu_torch.models.vae import VAEConfig
    from diffusion_finetuning_tpu_torch.ops import group_norm as gn

    dev = torch.device("cuda")
    cl = torch.channels_last
    log(f"limits, NHWC GroupNorm kernel vs plain version: bf16 {GN_TOL}, fp32 {GN_F32_TOL}")
    rows = []
    unets = {"sd15": UNetConfig.sd15, "sd21": UNetConfig.sd21, "sdxl": UNetConfig.sdxl}
    vaes = {"vae": VAEConfig.sd15, "sdxl_vae": VAEConfig.sdxl}
    for label, per, model, batch, side in sets:
        calls = (vae_decoder_group_norm_calls(vaes[model](), batch, side) if model in vaes
                 else unet_group_norm_calls(unets[model](), batch, side))
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for (b, c, h, w, has_add, silu), count in sorted(calls.items()):
            x = (torch.randn((b, c, h, w), generator=gen, device=dev) * 2 + 0.5).bfloat16()
            xc = x.contiguous(memory_format=cl)
            wt = (1 + 0.1 * torch.randn((c,), generator=gen, device=dev)).bfloat16()
            bias = (0.1 * torch.randn((c,), generator=gen, device=dev)).bfloat16()
            add = (torch.randn((b, c), generator=gen, device=dev).bfloat16() if has_add
                   else None)
            args = (32, wt, bias, 1e-5, add, silu)

            def library():
                h_ = x if add is None else x + add[:, :, None, None]
                y_ = F.group_norm(h_, 32, wt, bias, 1e-5)
                return F.silu(y_) if silu else y_

            with torch.inference_mode():
                y = gn._group_norm_cuda(xc, *args)
                again = gn._group_norm_cuda(xc, *args)
                y_ref = gn.group_norm_plain(xc, *args)
                torch.cuda.synchronize()
                mx, rel = errors(y, y_ref)
                peak = float(y_ref.float().abs().max())
                same = torch.equal(y, again)
                ok = (same and y.is_contiguous(memory_format=cl) and mx <= GN_TOL["max_rel"] * peak
                      and rel <= GN_TOL["rel_l2"] and bool(torch.isfinite(y).all()))
                ms = cuda_time(lambda: gn._group_norm_cuda(xc, *args), iters, flush)
                plain_ms = cuda_time(lambda: gn.group_norm_plain(xc, *args), 3, flush,
                                     hide_host=False)
                lib_ms = cuda_time(library, iters, flush)
            nbytes = 2 * (2 * x.numel() + (0 if add is None else add.numel()) + 2 * c)
            bound_ms, by = bound(0, nbytes)
            p = gn.plan(b, h * w, c)
            row = dict(shape=[b, c, h, w], add=has_add, silu=silu, model=model,
                       per_step=count if per == "per_step" else 0,
                       **({per: count} if per != "per_step" else {}),
                       max_abs_err=mx, max_rel_err=mx / peak, rel_l2=rel, repeat_equal=same,
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=by, plan=p._asdict(), bytes_share=bound_ms / ms if ms else None)
            rows.append(row)
            for k in tot:
                tot[k] += row[k] * count
            log(f"group_norm {model} B={b} C={c:4d} {h:3d}x{w:3d} add={int(has_add)} "
                f"silu={int(silu)} x{count:2d} plan threads={p.threads} tile={p.tile} "
                f"tiles={p.tiles}: max_abs={mx:.3e} rel_l2={rel:.3e} repeat equal {same} "
                f"ms={ms:.4f} plain={plain_ms:.3f} torch={lib_ms:.4f} bound={bound_ms:.4f} "
                f"({100 * bound_ms / ms if ms else 0:.1f}% of it) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"group_norm kernel disagrees at {row['shape']} add={has_add} silu={silu}")
            del x, xc, y, again, y_ref
        log(f"group_norm {label}, summed over its calls: {tot['ms']:.4f} ms, torch "
            f"{tot['library_ms']:.4f} (x{tot['ms'] / tot['library_ms']:.3f}), bound "
            f"{tot['bound_ms']:.4f} ({100 * tot['bound_ms'] / tot['ms']:.1f}% of it), plain "
            f"{tot['plain_ms']:.3f}")
    if not fp32:
        return rows
    # fp32 once, ragged: a 12x11 image, 640 channels, the add and SiLU
    x = torch.randn((2, 640, 12, 11), generator=gen, device=dev).contiguous(memory_format=cl)
    wt, bias = (torch.randn((640,), generator=gen, device=dev) for _ in range(2))
    add = torch.randn((2, 640), generator=gen, device=dev)
    with torch.inference_mode():
        y = gn._group_norm_cuda(x, 32, wt, bias, 1e-6, add, True)
        y_ref = gn.group_norm_plain(x, 32, wt, bias, 1e-6, add, True)
        mx, rel = errors(y, y_ref)
    peak = float(y_ref.abs().max())
    log(f"group_norm fp32 (2, 640, 12x11) add silu: max_rel={mx / peak:.3e} rel_l2={rel:.3e}")
    if not (mx <= GN_F32_TOL["max_rel"] * peak and rel <= GN_F32_TOL["rel_l2"]):
        fail("fp32 group_norm kernel disagrees")
    return rows


def flash_bwd_rows(gen, flush, iters):
    """K3 at every training shape (BH = 8): dQ, dK, dV against the plain
    version on the same bf16 inputs (O and lse from K1); all three repeat
    bit for bit, and dQ at half and twice the rule's q splits equals dQ at
    the rule's (it is summed over the KV tiles in their order); its time
    beside those splits, beside the parent's K3 (``K3_UNORDERED``, whose dQ
    was summed in no fixed order) and the first design (``K3_PREV``), the
    plain version's, SDPA's backward alone, and the bound."""
    import torch
    import torch.nn.functional as F

    from diffusion_finetuning_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    bh = FLASH_BWD_BH
    log(f"limits, flash backward bf16 kernel vs plain version: {FLASH_BWD_TOL}")
    rows = []
    for sq, skv, d, count in FLASH_SHAPES:
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device=dev, dtype=torch.bfloat16)
                       for s in (sq, skv, skv, sq))
        scale = d ** -0.5
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, scale)
            delta = fa._delta(o, do)
            splits = fa.bwd_q_splits(bh, sq, skv, d)
            got = fa.flash_bwd(q, k, v, o, lse, do, scale)
            again = fa.flash_bwd(q, k, v, o, lse, do, scale)
            want = fa.flash_backward_plain(q, k, v, o, lse, do, scale, q_splits=splits)
            # the split rule's choice beside half and twice as many splits
            n_q = -(-sq // fa.bwd_q_rows(d))
            others = sorted({max(1, splits // 2), min(n_q, 2 * splits)} - {splits})
            dq_other = [fa._bwd_cuda(q, k, v, lse, delta, do, scale, q_splits=n)[0]
                        for n in others]
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            dq_splits_same = all(torch.equal(got[0], x) for x in dq_other)
            errs = {}
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                mx, rel = errors(a, b)
                errs[name] = (mx, mx / float(b.float().abs().max()), rel,
                              bool(torch.isfinite(a).all()))
            ok = same and dq_splits_same and all(
                r <= FLASH_BWD_TOL["max_rel"] and l2 <= FLASH_BWD_TOL["rel_l2"] and fin
                for _, r, l2, fin in errs.values())
            ms = cuda_time(lambda: fa._bwd_cuda(q, k, v, lse, delta, do, scale), iters, flush)
            other_ms = {n: cuda_time(lambda: fa._bwd_cuda(q, k, v, lse, delta, do, scale,
                                                          q_splits=n), iters, flush)
                        for n in others}
            plain_ms = cuda_time(lambda: fa.flash_backward_plain(q, k, v, o, lse, do, scale),
                                 3, flush, hide_host=False)
        q4, k4, v4 = (t.reshape(1, bh, -1, d).detach().requires_grad_(True) for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4)
        do4 = do.reshape(1, bh, sq, d)
        lib_ms = cuda_time(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                       retain_graph=True), iters, flush)
        flops = 10 * bh * sq * skv * d
        nbytes = 2 * bh * (3 * sq + 4 * skv) * d + 8 * bh * sq
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        by = "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes"
        prev = K3_PREV[1][(sq, skv, d)]
        unordered = K3_UNORDERED[1][(sq, skv, d)]
        row = dict(shape=[bh, sq, skv, d], per_step=count,
                   max_abs_err=max(e[0] for e in errs.values()),
                   rel_l2=max(e[2] for e in errs.values()),
                   errors={n: dict(max_abs=e[0], max_rel=e[1], rel_l2=e[2])
                           for n, e in errs.items()},
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                   q_splits=splits, ctas=-(-skv // 64) * bh * splits,
                   other_splits_ms=other_ms, deterministic=same,
                   dq_same_across_splits=dq_splits_same)
        rows.append(row)
        log(f"flash bwd BH={bh} Sq={sq:5d} Skv={skv:5d} d={d:3d} q_splits={splits:2d} "
            f"({row['ctas']} CTAs): "
            + " ".join(f"{n} max_abs={e[0]:.2e} rel_l2={e[2]:.2e}" for n, e in errs.items())
            + f" dQ/dK/dV repeat equal {same}, dQ equal across splits {others} "
            f"{dq_splits_same} ms={ms:.4f} ("
            + "".join(f"q_splits {n}: {t:.4f}; " for n, t in other_ms.items())
            + f"{K3_UNORDERED[0]}: {unordered:.4f}; {K3_PREV[0]}: {prev:.4f}) "
            f"plain={plain_ms:.3f} sdpa_bwd={lib_ms:.4f} "
            f"bound={bound:.4f} ({by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash attention backward kernel disagrees at {row['shape']}")
    ours = sum(r["ms"] * r["per_step"] for r in rows)
    before = sum(K3_UNORDERED[1][tuple(r["shape"][1:])] * r["per_step"] for r in rows)
    log(f"flash bwd summed over a train step's calls: {ours:.4f} ms ({K3_UNORDERED[0]}: "
        f"{before:.4f}, x{ours / before:.3f})")
    # K3's fp32 pair at a ragged shape (fp32_rows times it at the SD1.5 shapes)
    q, k, v, do = (torch.randn((4, s, 40), generator=gen, device=dev) for s in (200, 77, 77, 200))
    with torch.inference_mode():
        o, lse = fa.flash_fwd(q, k, v, 0.2)
        got = fa.flash_bwd(q, k, v, o, lse, do, 0.2)
        want = fa.flash_backward_plain(q, k, v, o, lse, do, 0.2)
    rels = [errors(a, b)[1] for a, b in zip(got, want)]
    log(f"flash bwd fp32 (4, 200, 77, 40): rel_l2 dq/dk/dv {rels}")
    if not max(rels) <= 1e-4:
        fail("fp32 flash attention backward kernel disagrees")
    return rows


# ---------------------------------------------------------------------------
# the models: random SD1.5 weights and a rank-4 LoRA from fixed seeds
# ---------------------------------------------------------------------------

SEED = 0
LORA_UP_STD = 0.01  # non-zero up: the LoRA term moves every projection
IMAGE = 512      # served image side (64x64 latents)
STEPS = 50
GUIDANCE = 7.5
REF_IMAGE = 128  # image side of the card-vs-CPU txt2img check
# mean |diff| of [0, 1] images: card bf16 vs CPU fp32 txt2img at 128^2 and
# 3 DDIM steps, and merged vs dynamic LoRA for one seed at 512^2 and 50
# steps (bf16 rounds W + delta and W x + delta x at different places)
PIPE_MEAN_ABS = 2e-2


def sd15_configs():
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig
    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig
    from diffusion_finetuning_tpu_torch.models.vae import VAEConfig

    return UNetConfig.sd15(), VAEConfig.sd15(), CLIPTextConfig.sd15()


def random_weights(ucfg, vcfg, tcfg, seed=SEED):
    """State dicts of the UNet, VAE and CLIP text encoder with torch's
    default initialisation under ``seed``, rounded to bf16 once, so that the
    card's bf16 models and the CPU's fp32 reference hold the same values."""
    import torch

    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextModel
    from diffusion_finetuning_tpu_torch.models.unet import UNet2DConditionModel
    from diffusion_finetuning_tpu_torch.models.vae import AutoencoderKL

    out = []
    for i, (cls, cfg) in enumerate(((UNet2DConditionModel, ucfg), (AutoencoderKL, vcfg),
                                    (CLIPTextModel, tcfg))):
        torch.manual_seed(seed + i)
        out.append({k: v.to(torch.bfloat16) for k, v in cls(cfg).state_dict().items()})
    return out


def random_lora(ucfg, seed=SEED + 10, replace=None):
    """A rank-4 LoRA tree on the UNet targets of ``replace`` (default: the
    default targets; bf16, on the CPU): ``inject_trainable_lora``'s down,
    and an up drawn non-zero."""
    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.models.unet import unet_all_lora_targets

    g = torch.Generator().manual_seed(seed)
    targets = lora_lib.filter_targets(unet_all_lora_targets(ucfg),
                                      replace or lora_lib.DEFAULT_TARGET_REPLACE)
    tree = lora_lib.inject_trainable_lora(targets, g, r=LORA_RANK, dtype=torch.bfloat16)
    for _, leaf in lora_lib.lora_leaves(tree):
        leaf["up"] = (torch.randn(leaf["up"].shape, generator=g) * LORA_UP_STD).bfloat16()
    return tree


def tree_to(tree, device):
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def build_pipe(ucfg, vcfg, tcfg, sds, dtype, device, scheduler=None):
    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu_torch.models.schedulers import SchedulerConfig
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline

    return StableDiffusionPipeline(
        ucfg, sds[0], vcfg, sds[1], tcfg, sds[2],
        CLIPTokenizer.tiny(["photo", "of", "sks", "person"]), scheduler or SchedulerConfig(),
        dtype=dtype, device=device)


# kernel -> (module, its launch counter)
COUNTERS = {
    "flash_attention_fwd": ("flash_attention", "launches"),
    "flash_attention_fwd_packed": ("flash_attention", "packed_launches"),
    "flash_attention_fwd_fp32": ("flash_attention", "fp32_launches"),
    "flash_attention_bwd": ("flash_attention", "bwd_launches"),
    "flash_attention_bwd_fp32": ("flash_attention", "bwd_fp32_launches"),
    "lora_dense": ("lora_matmul", "launches"),
    "lora_dense_fp32": ("lora_matmul", "fp32_launches"),
    "conv3x3": ("conv3x3", "launches"),
    "conv3x3_fp32": ("conv3x3", "fp32_launches"),
    # calls, each of two kernels (statistics, then normalisation), as K3's
    "group_norm": ("group_norm", "launches"),
}


def _op(module):
    import importlib

    return importlib.import_module(f"diffusion_finetuning_tpu_torch.ops.{module}")


def counts():
    return {name: getattr(_op(mod), attr) for name, (mod, attr) in COUNTERS.items()}


def reset_counts():
    for mod, attr in COUNTERS.values():
        setattr(_op(mod), attr, 0)


def want_counts(**launches):
    """Expected launches of every kernel: those named, 0 for the rest."""
    assert set(launches) <= set(COUNTERS), launches
    return {name: launches.get(name, 0) for name in COUNTERS}


def set_switches(on):
    """Phase 6's opt-in kernels: the fused 3x3 conv in the UNet's resnets
    (``DFT_CONV_PALLAS``) and head-packed flash forwards (G = HEAD_PACK)."""
    from diffusion_finetuning_tpu_torch.models import layers
    from diffusion_finetuning_tpu_torch.ops import flash_attention as fa

    layers.CONV_KERNEL = on
    fa.DEFAULT_HEAD_PACK = HEAD_PACK if on else 1


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def unet_step_inputs(pipe):
    """The UNet step's inputs on the CPU: CFG pair at 64x64 latents (bf16),
    bf16 text context, t = 500."""
    import torch

    ucfg = pipe.unet_config
    g = torch.Generator().manual_seed(SEED + 20)
    side = IMAGE // pipe.vae_scale_factor
    x = torch.randn((2, ucfg.in_channels, side, side), generator=g).bfloat16()
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=g).bfloat16()
    return x, torch.tensor([500, 500]), ctx


def phase_unet_step(pipe, unet_sd, lora_cpu, lora_dev, profile_dir=None):
    """One UNet step as ``entry()`` runs it: CFG pair at 64x64 latents, bf16,
    dynamic rank-4 LoRA.  Held against the same UNet in fp32 on the CPU
    (plain versions of both kernels), and timed with and without the LoRA.
    Returns its numbers and the CPU output (phase 6 reuses it)."""
    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.models.unet import UNet2DConditionModel
    from diffusion_finetuning_tpu_torch.models.weights import load_module

    ucfg = pipe.unet_config
    x, t, ctx = unet_step_inputs(pipe)
    dev = pipe.device
    xd, td, cd = x.to(dev), t.to(dev), ctx.to(dev)
    unet = pipe.unet
    profiles = []
    with torch.inference_mode():
        with lora_lib.attached(unet, lora_dev):
            before = counts()
            out = unet(xd, td, cd)
            torch.cuda.synchronize()
            per_call = {k: v - before[k] for k, v in counts().items()}
            lora_ms = wall_ms(lambda: unet(xd, td, cd), 10)
            if profile_dir:
                profiles.append(profile_step(lambda: unet(xd, td, cd), "dynamic_lora",
                                             profile_dir))
        base = unet(xd, td, cd)
        base_ms = wall_ms(lambda: unet(xd, td, cd), 10)
        if profile_dir:
            profiles.append(profile_step(lambda: unet(xd, td, cd), "no_lora", profile_dir))
    want_calls = want_counts(flash_attention_fwd=FLASH_PER_STEP, lora_dense=LORA_PER_STEP)
    log(f"unet step: launches {per_call} (want {want_calls}); "
        f"ms dynamic-LoRA {lora_ms:.3f}, no LoRA {base_ms:.3f}")
    if per_call != want_calls:
        fail(f"UNet step launched {per_call}, want {want_calls}")
    if not bool(torch.isfinite(out).all()):
        fail("UNet step output is not finite")

    t0 = time.time()
    ref_model = load_module(UNet2DConditionModel, ucfg, unet_sd, torch.float32, "cpu")
    with torch.inference_mode(), lora_lib.attached(ref_model, lora_cpu):
        ref = ref_model(x.float(), t, ctx.float())
    del ref_model
    _, rel = errors(out.cpu(), ref)
    _, lora_effect = errors(out.cpu(), base.cpu())
    log(f"unet step vs CPU fp32: rel_l2={rel:.3e} (limit {UNET_REL_L2}); LoRA moves the "
        f"output by rel_l2={lora_effect:.3e}; CPU reference {time.time() - t0:.1f} s")
    if not rel <= UNET_REL_L2:
        fail(f"UNet step disagrees with the CPU fp32 reference: {rel:.3e}")
    if not lora_effect > 4 * rel:
        fail("the LoRA barely moves the UNet output: the comparison would not see it")
    return {"unet_step_ms_dynamic_lora": lora_ms, "unet_step_ms_no_lora": base_ms,
            "unet_rel_l2": rel, "lora_effect_rel_l2": lora_effect, "profiles": profiles}, ref


KERNEL_KINDS = (  # (kind, substrings of the device kernel's name), first match wins
    ("flash_attention_fwd_packed (ours)", ("flash_fwd_bf16_packed",)),
    ("flash_attention_fwd_fp32 (ours)", ("flash_fwd_f32",)),
    ("flash_attention_fwd (ours)", ("flash_fwd",)),
    ("flash_attention_bwd_fp32 (ours)", ("flash_bwd_f32", "flash_bwd_dq_f32")),
    ("flash_attention_bwd (ours)", ("flash_bwd",)),
    ("fp32 split copies (ours)", ("split_rows", "split_cols")),
    ("lora_dense (ours)", ("lora_dense",)),
    ("conv3x3 (ours)", ("conv3x3",)),
    ("cuDNN NCHW<->NHWC transposes", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "implicit_gemm", "winograd", "fprop")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("normalisation", ("norm", "moments", "computefusedparams")),
    ("copies (contiguous, cat)", ("copy",)),
)


# device kernel -> the launch counter of its wrapper, and the kernels one
# launch runs (K3: its dK/dV kernel and its dQ kernel; the NHWC GroupNorm:
# its statistics kernel and its normalisation kernel; the fp32 kernels'
# split copies are not counted); first match wins
DEVICE_KERNELS = (("flash_fwd_bf16_packed", "flash_attention_fwd_packed", 1),
                  ("flash_fwd_f32", "flash_attention_fwd_fp32", 1),
                  ("flash_fwd", "flash_attention_fwd", 1),
                  ("flash_bwd_dq", None, 0),
                  ("flash_bwd_f32", "flash_attention_bwd_fp32", 1),
                  ("flash_bwd", "flash_attention_bwd", 1),
                  ("lora_dense_f32", "lora_dense_fp32", 1),
                  ("lora_dense", "lora_dense", 1),
                  ("conv3x3_f32", "conv3x3_fp32", 1),
                  ("conv3x3", "conv3x3", 1),
                  ("group_norm_stats", "group_norm", 1),
                  ("group_norm_apply", None, 0))


def profile_step(fn, label, out_dir, cpu=True, warm=True):
    """Trace one step with torch.profiler: device time by kernel kind
    and the card's idle share over the step's wall time, and the launches of
    the port's kernels it saw on the device (``launches``, by counter
    name).  The per-kernel table goes to
    ``out_dir``/unet_step_profile_<label>.txt (no table without ``out_dir``).
    ``cpu=False`` traces the device only (cheaper for long eager runs);
    ``warm=False`` skips the untraced call before."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, by_kind = {}, {}
    for e in prof.events():
        # device kernels only: a user annotation (Optimizer.step#AdamW.step)
        # is a span on the device timeline, not work
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = e.time_range.elapsed_us()
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + us)
        low = e.name.lower()
        kind = next((k for k, subs in KERNEL_KINDS if any(x in low for x in subs)),
                    "elementwise and other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    busy = sum(by_kind.values())
    if busy <= 0:
        fail("the profiler saw no device time")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"unet_step_profile_{label}.txt"), "w") as f:
            for name, (n, us) in rows:
                f.write(f"{us / 1e3:10.3f} ms {n:6d} x  {name}\n")
    launches = want_counts()
    for name, (n, _) in by_name.items():
        counter, per = next(((c, k) for sub, c, k in DEVICE_KERNELS if sub in name), (None, 0))
        if counter is not None:
            launches[counter] += n * per
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
        f"idle share {1 - busy / wall_us:.3f}, "
        f"{sum(n for n, _ in by_name.values())} kernels")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"  {kind:28s} {us / 1e3:8.3f} ms  {us / busy:6.1%}")
    for name, (n, us) in rows[:12]:
        log(f"  {us / 1e3:8.3f} ms {n:5d} x {name[:100]}")
    return {"label": label, "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us,
            "kernels": sum(n for n, _ in by_name.values()), "launches": launches,
            "by_kind_ms": {k: v / 1e3 for k, v in by_kind.items()}}


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def phase_pipeline_reference(pipe, ref_pipe, lora_cpu, lora_dev):
    """txt2img at a small input (128^2, 3 DDIM steps, CFG, dynamic LoRA, the
    same given latents) on the card in bf16 and on the CPU in fp32."""
    import numpy as np

    side = REF_IMAGE // pipe.vae_scale_factor
    lat = np.random.default_rng(SEED + 30).standard_normal((2, side, side, 4)).astype(np.float32)
    kw = dict(height=REF_IMAGE, width=REF_IMAGE, num_inference_steps=3, guidance_scale=GUIDANCE,
              latents=lat, output_type="np")
    prompts = ["a photo of sks", "photo of sks person"]
    for p, tree in ((pipe, lora_dev), (ref_pipe, lora_cpu)):
        p.unet_lora, p.materialize_lora = tree, False
    got = pipe(prompts, **kw)
    t0 = time.time()
    want = ref_pipe(prompts, **kw)
    diff = np.abs(got - want)
    log(f"txt2img 128^2 x3 steps, card bf16 vs CPU fp32: mean |diff| {diff.mean():.3e} "
        f"(limit {PIPE_MEAN_ABS}), max {diff.max():.3e}, image std {got.std():.3e}; "
        f"CPU reference {time.time() - t0:.1f} s")
    if got.shape != (2, REF_IMAGE, REF_IMAGE, 3) or not diff.mean() <= PIPE_MEAN_ABS:
        fail("txt2img on the card disagrees with the CPU fp32 reference")
    if not got.std() > 1e-3:
        fail("txt2img images are constant")


def phase_serving(pipe, lora_dev):
    """The main path: txt2img requests through ``StableDiffusionPipeline.__call__``
    at 512^2, 50 DDIM steps, CFG.  The launch counters are set to 0 just before
    and read just after; every UNet step must have gone through the flash
    kernel 32 times and, on the dynamic-LoRA request, the LoRA kernel 144
    times."""
    import numpy as np
    import torch

    finite = []
    hook = pipe.vae.decoder.register_forward_hook(
        lambda mod, inp, out: finite.append(bool(torch.isfinite(out).all())))
    pipe.unet_lora = lora_dev
    for mat in (True, False):  # warm-up, not counted: one step on each route
        pipe.materialize_lora = mat
        pipe("photo", num_inference_steps=1, seed=0, output_type="uint8")
    finite.clear()

    requests = [  # (prompt, seed, materialize_lora)
        ("a photo of sks", 1, True),
        ("a photo of sks person", 2, True),
        (["photo of sks", "a photo of sks person"], [3, 4], True),
        ("a photo of sks", 1, False),
    ]
    rows, images = [], []
    reset_counts()
    for prompt, seed, mat in requests:
        pipe.materialize_lora = mat
        torch.cuda.synchronize()
        t0 = time.time()
        imgs = pipe(prompt, seed=seed, num_inference_steps=STEPS,
                    guidance_scale=GUIDANCE, height=IMAGE, width=IMAGE, output_type="uint8")
        sec = time.time() - t0
        b = 1 if isinstance(prompt, str) else len(prompt)
        rows.append(dict(batch=b, lora="merged" if mat else "dynamic", seconds=sec,
                         s_per_image=sec / b))
        images.append(imgs)
        log(f"request batch={b} lora={'merged' if mat else 'dynamic'}: {sec:.3f} s, "
            f"{sec / b:.3f} s/image, image std {imgs.std():.2f}")
    launched = counts()
    hook.remove()

    n_dynamic = sum(1 for *_, mat in requests if not mat)
    want = want_counts(flash_attention_fwd=FLASH_PER_STEP * STEPS * len(requests),
                       lora_dense=LORA_PER_STEP * STEPS * n_dynamic,
                       group_norm=pipe_norms(pipe, STEPS) * len(requests))
    log(f"serving launches {launched} (want {want})")
    if launched != want:
        fail(f"the main path launched {launched}, want {want}")
    check_no_fallbacks("serving")
    for imgs, (prompt, *_rest) in zip(images, requests):
        b = 1 if isinstance(prompt, str) else len(prompt)
        if imgs.shape != (b, IMAGE, IMAGE, 3) or imgs.dtype != np.uint8:
            fail(f"image batch {imgs.shape} {imgs.dtype}")
        if not all(im.std() > 0 for im in imgs):
            fail("a served image is constant")
    if len(finite) != len(requests) or not all(finite):
        fail(f"decoded images not finite: {finite}")
    # the same seed through the merged and the dynamic LoRA
    diff = np.abs(images[0].astype(np.float32) - images[3].astype(np.float32)) / 255
    log(f"seed 1, merged vs dynamic LoRA: mean |diff| {diff.mean():.3e} "
        f"(limit {PIPE_MEAN_ABS}), max {diff.max():.3e}")
    if not diff.mean() <= PIPE_MEAN_ABS:
        fail("the merged and the dynamic LoRA give different images for one seed")
    check_blocks(pipe, SD_BLOCKS, "sd15")
    return launched, rows


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-4
TRAIN_STEPS = 10
TRAIN_WARMUP = 2


def train_batch(tokenizer, seed=SEED + 40, side=IMAGE):
    """One ``side``^2 uint8 example and its prompt ids (the trainers' wire format)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = tokenizer(["a photo of sks person"], padding="max_length", max_length=77,
                    return_tensors="np")["input_ids"].astype(np.int32)
    return {"pixel_values": rng.integers(0, 256, (1, side, side, 3), dtype=np.uint8),
            "input_ids": ids}


def phase_train_reference(pipe, ucfg, vcfg, tcfg, sds, lora_cpu, batch, device="cuda",
                          cpu_ref=None, cpu_models=None):
    """One loss_step and its backward under the pipe's scheduler config: bf16
    on the card against fp32 on the CPU, from the same cached latent moments
    (the card's VAE encode) and the same draws.  ``cpu_ref`` (loss,
    gradient) of an earlier call stands in for the CPU run; ``cpu_models``
    (UNet, text encoder, VAE in fp32 on the CPU) for loading them from
    ``sds``.  Returns the numbers and (CPU loss, CPU gradient)."""
    import numpy as np
    import torch

    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextModel
    from diffusion_finetuning_tpu_torch.models.schedulers import DDPMScheduler
    from diffusion_finetuning_tpu_torch.models.unet import UNet2DConditionModel
    from diffusion_finetuning_tpu_torch.models.vae import AutoencoderKL
    from diffusion_finetuning_tpu_torch.models.weights import load_module
    from diffusion_finetuning_tpu_torch.training.latent_cache import LatentMomentCache
    from diffusion_finetuning_tpu_torch.training.loss import loss_step
    from diffusion_finetuning_tpu_torch.training.optim import trainable_tensors
    from diffusion_finetuning_tpu_torch.training.train_step import master_tree

    cached = LatentMomentCache(pipe.vae, device=device).transform(batch)
    rng = np.random.default_rng(SEED + 41)
    side = batch["pixel_values"].shape[1] // pipe.vae_scale_factor
    draws = {"sample": rng.standard_normal((1, side, side, 4)).astype(np.float32),
             "noise": rng.standard_normal((1, side, side, 4)).astype(np.float32),
             "timesteps": np.array([rng.integers(0, 1000)])}

    def run(unet, text_encoder, vae, device):
        master = master_tree(lora_cpu, device)
        loss = loss_step(cached, unet=unet, text_encoder=text_encoder, vae=vae,
                         scheduler=DDPMScheduler(pipe.scheduler_config), unet_lora=master,
                         draws=draws)
        loss.backward()
        grad = torch.cat([t.grad.float().cpu().reshape(-1) for t in trainable_tensors(master)])
        return float(loss.detach()), grad

    loss_dev, grad_dev = run(pipe.unet, pipe.text_encoder, pipe.vae, device)
    torch.cuda.synchronize()
    t0 = time.time()
    if cpu_ref is None:
        cpu = cpu_models or [load_module(cls, cfg, sd, torch.float32, "cpu") for cls, cfg, sd in (
            (UNet2DConditionModel, ucfg, sds[0]), (CLIPTextModel, tcfg, sds[2]),
            (AutoencoderKL, vcfg, sds[1]))]
        cpu_ref = run(*cpu, "cpu")
        del cpu
    loss_cpu, grad_cpu = cpu_ref
    _, rel = errors(grad_dev, grad_cpu)
    log(f"train loss_step + backward, card bf16 vs CPU fp32: loss {loss_dev:.6f} vs "
        f"{loss_cpu:.6f} (diff {abs(loss_dev - loss_cpu):.3e}); LoRA gradient rel_l2 "
        f"{rel:.3e} (limit {TRAIN_GRAD_REL_L2}), norm {float(grad_cpu.norm()):.3e}; "
        f"CPU reference {time.time() - t0:.1f} s")
    if not (np.isfinite(loss_dev) and rel <= TRAIN_GRAD_REL_L2):
        fail("the training step's LoRA gradient on the card disagrees with the CPU fp32 one")
    if not float(grad_cpu.norm()) > 0:
        fail("the reference LoRA gradient is zero: the comparison would see nothing")
    return {"loss_card": loss_dev, "loss_cpu": loss_cpu, "grad_rel_l2": rel}, cpu_ref


def phase_train(pipe, ucfg, lora_cpu, batch, per_step, profile_dir=None, device="cuda",
                steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, label="train_step", ckpt_want=None):
    """The training path: ``build_train_step`` on the card, ``warmup`` and
    ``steps`` timed steps, then one step with gradient checkpointing.  The
    launch counters are set to 0 just before the timed steps and read just
    after; ``per_step`` are the launches a step must make, ``ckpt_want`` the
    checkpointed step's (default: twice the forward kernels')."""
    import dataclasses

    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.models.schedulers import DDPMScheduler, SchedulerConfig
    from diffusion_finetuning_tpu_torch.training.optim import (
        ParamGroup, multi_group_optimizer, trainable_tensors)
    from diffusion_finetuning_tpu_torch.training.train_step import (
        TrainablePartition, build_train_step, init_train_state)

    opt = multi_group_optimizer({"unet_lora": ParamGroup(lr=TRAIN_LR)}, max_grad_norm=1.0)
    state = init_train_state(opt, unet_lora=lora_cpu, device=device)
    step = build_train_step(unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae,
                            scheduler=DDPMScheduler(SchedulerConfig()), optimizer=opt,
                            partition=TrainablePartition(unet_lora=True))
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    first = [t.detach().clone() for t in trainable_tensors(state["params"])]
    scales = [float(leaf["scale"]) for _, leaf in lora_lib.lora_leaves(state["params"]["unet_lora"])]
    for _ in range(warmup):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, wall = [], []
    reset_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    launched = counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    med = sorted(wall)[len(wall) // 2]
    want = {name: n * steps for name, n in per_step.items()}
    moved = max(float((a.detach() - b).abs().max()) for a, b in
                zip(trainable_tensors(state["params"]), first))
    scales_now = [float(leaf["scale"])
                  for _, leaf in lora_lib.lora_leaves(state["params"]["unet_lora"])]
    log(f"{label} x{steps} (512^2, batch 1, uint8, rank {LORA_RANK}, AdamW lr {TRAIN_LR}, "
        f"clip 1.0): "
        f"wall ms median {med:.3f} (min {min(wall):.3f}, max {max(wall):.3f}), "
        f"{1e3 / med:.3f} steps/s, peak memory {peak / 2**30:.3f} GiB; losses "
        f"{[round(x, 5) for x in losses]}; launches {launched} (want {want}); "
        f"LoRA moved by max {moved:.3e}")
    if launched != want:
        fail(f"the training path launched {launched}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"a training loss is not finite: {losses}")
    if not moved > 0:
        fail("the LoRA leaves did not move")
    if scales_now != scales:
        fail("a LoRA scale leaf moved")
    profiles = []
    if profile_dir:
        profiles.append(profile_step(lambda: step(state, batch, gen), label, profile_dir))

    unet = pipe.unet
    unet.config = dataclasses.replace(ucfg, gradient_checkpointing=True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        ckpt_ms = (time.perf_counter() - t0) * 1e3
        ckpt_launched = counts()
        ckpt_peak = torch.cuda.max_memory_allocated()
    finally:
        unet.config = ucfg
    if ckpt_want is None:
        ckpt_want = {name: n * (1 if name == "flash_attention_bwd" else 2)
                     for name, n in per_step.items()}
    log(f"train step with gradient checkpointing: wall ms {ckpt_ms:.3f}, peak memory "
        f"{ckpt_peak / 2**30:.3f} GiB, loss {float(m['loss']):.5f}; launches {ckpt_launched} "
        f"(want {ckpt_want})")
    if ckpt_launched != ckpt_want:
        fail(f"the checkpointed step launched {ckpt_launched}, want {ckpt_want}")
    if not math.isfinite(float(m["loss"])):
        fail("the checkpointed step's loss is not finite")
    return launched, {"step_ms": wall, "step_ms_median": med, "steps_per_s": 1e3 / med,
                      "peak_bytes": peak, "losses": losses, "checkpointed_step_ms": ckpt_ms,
                      "checkpointed_peak_bytes": ckpt_peak, "profiles": profiles}


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

STRENGTH = 0.75
IMG2IMG_REF_STEPS = 4  # strength 0.75: t_start 1, 3 UNet steps


def init_image(side):
    """A smooth uint8 (side, side, 3) test image: two ramps and a pattern."""
    import numpy as np

    yy, xx = np.mgrid[0:side, 0:side] / side
    img = np.stack([xx, yy, 0.5 + 0.5 * np.sin(8 * xx) * np.cos(6 * yy)], axis=-1)
    return np.round(img * 255).astype(np.uint8)


def phase_switched_unet_step(pipe, lora_dev, ref, per_step, profile_dir=None):
    """Phase 3's UNet step with both switches on: the same inputs through
    K5, K4 and K2, held against phase 3's CPU fp32 output."""
    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib

    x, t, ctx = (a.to(pipe.device) for a in unet_step_inputs(pipe))
    unet = pipe.unet
    profiles = []
    with torch.inference_mode(), lora_lib.attached(unet, lora_dev):
        before = counts()
        out = unet(x, t, ctx)
        torch.cuda.synchronize()
        per_call = {k: v - before[k] for k, v in counts().items()}
        ms = wall_ms(lambda: unet(x, t, ctx), 10)
        if profile_dir:
            profiles.append(profile_step(lambda: unet(x, t, ctx), "switched_dynamic_lora",
                                         profile_dir))
    _, rel = errors(out.cpu(), ref)
    log(f"switched unet step: launches {per_call} (want {per_step}); ms dynamic-LoRA "
        f"{ms:.3f}; vs CPU fp32 rel_l2={rel:.3e} (limit {UNET_REL_L2})")
    if per_call != per_step:
        fail(f"the switched UNet step launched {per_call}, want {per_step}")
    if not (bool(torch.isfinite(out).all()) and rel <= UNET_REL_L2):
        fail(f"the switched UNet step disagrees with the CPU fp32 reference: {rel:.3e}")
    return {"unet_step_ms_dynamic_lora": ms, "unet_rel_l2": rel, "profiles": profiles}


def phase_img2img_reference(pipe, ref_pipe, lora_cpu, lora_dev):
    """img2img at 128^2 (4 DDIM steps, strength 0.75, CFG, dynamic LoRA) on
    the card in bf16 and on the CPU in fp32, the same draws handed to both."""
    import numpy as np

    side = REF_IMAGE // pipe.vae_scale_factor
    rng = np.random.default_rng(SEED + 60)
    prompts = ["a photo of sks", "photo of sks person"]
    draws = {"sample": rng.standard_normal((1, side, side, 4)).astype(np.float32),
             "noise": rng.standard_normal((2, side, side, 4)).astype(np.float32)}
    kw = dict(strength=STRENGTH, num_inference_steps=IMG2IMG_REF_STEPS, guidance_scale=GUIDANCE,
              draws=draws, output_type="np")
    for p, tree in ((pipe, lora_dev), (ref_pipe, lora_cpu)):
        p.unet_lora, p.materialize_lora = tree, False
    got = pipe.img2img(prompts, init_image(REF_IMAGE), **kw)
    t0 = time.time()
    want = ref_pipe.img2img(prompts, init_image(REF_IMAGE), **kw)
    diff = np.abs(got - want)
    log(f"img2img 128^2 x{IMG2IMG_REF_STEPS} steps, strength {STRENGTH}, card bf16 vs CPU fp32: "
        f"mean |diff| {diff.mean():.3e} (limit {PIPE_MEAN_ABS}), max {diff.max():.3e}, "
        f"image std {got.std():.3e}; CPU reference {time.time() - t0:.1f} s")
    if got.shape != (2, REF_IMAGE, REF_IMAGE, 3) or not diff.mean() <= PIPE_MEAN_ABS:
        fail("img2img on the card disagrees with the CPU fp32 reference")
    if not got.std() > 1e-3:
        fail("img2img images are constant")
    return {"mean_abs_diff": float(diff.mean()), "max_abs_diff": float(diff.max())}


def phase_img2img(pipe, lora_dev, per_step):
    """Phase 6's main path: img2img requests through
    ``StableDiffusionPipeline.img2img`` at 512^2, 50 DDIM steps, strength
    0.75, CFG, dynamic LoRA.  The launch counters are set to 0 just before
    and read just after: every UNet step must have made ``per_step``."""
    import numpy as np
    import torch

    from diffusion_finetuning_tpu_torch.pipelines.pipeline import img2img_start

    finite = []
    hook = pipe.vae.decoder.register_forward_hook(
        lambda mod, inp, out: finite.append(bool(torch.isfinite(out).all())))
    pipe.unet_lora, pipe.materialize_lora = lora_dev, False
    image = init_image(IMAGE)
    pipe.img2img("photo", image, strength=0.5, num_inference_steps=2, seed=0,
                 output_type="uint8")  # warm-up, not counted
    finite.clear()
    requests = [("a photo of sks", 1), (["photo of sks", "a photo of sks person"], 2)]
    unet_steps = STEPS - img2img_start(STEPS, STRENGTH)
    rows, images = [], []
    reset_counts()
    for prompt, seed in requests:
        torch.cuda.synchronize()
        t0 = time.time()
        imgs = pipe.img2img(prompt, image, strength=STRENGTH, num_inference_steps=STEPS,
                            guidance_scale=GUIDANCE, seed=seed, output_type="uint8")
        sec = time.time() - t0
        b = 1 if isinstance(prompt, str) else len(prompt)
        rows.append(dict(batch=b, lora="dynamic", unet_steps=unet_steps, seconds=sec,
                         s_per_image=sec / b))
        images.append((b, imgs))
        log(f"img2img request batch={b} ({unet_steps} UNet steps): {sec:.3f} s, "
            f"{sec / b:.3f} s/image, image std {imgs.std():.2f}")
    launched = counts()
    hook.remove()
    want = {name: n * unet_steps * len(requests) for name, n in per_step.items()}
    want["group_norm"] = pipe_norms(pipe, unet_steps, encode=True) * len(requests)
    log(f"img2img launches {launched} (want {want})")
    if launched != want:
        fail(f"the img2img path launched {launched}, want {want}")
    for b, imgs in images:
        if imgs.shape != (b, IMAGE, IMAGE, 3) or imgs.dtype != np.uint8:
            fail(f"img2img image batch {imgs.shape} {imgs.dtype}")
        if not all(im.std() > 0 for im in imgs):
            fail("an img2img image is constant")
    if len(finite) != len(requests) or not all(finite):
        fail(f"decoded img2img images not finite: {finite}")
    return launched, rows


def phase_merged_conv_cache(pipe, ucfg, per_step):
    """Merged serving with a LoRA on the resnet convs too
    (``UNET_EXTENDED_TARGET_REPLACE``), the fused conv on: two txt2img
    requests of one UNet step each.  The first merges the LoRA and makes
    the tap-major copy of every routed conv's merged weight; the second
    must make none (``conv3x3.tap_major_copies`` read around it), and both
    must launch ``per_step`` kernels (no LoRA kernel: the LoRA is merged)."""
    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.ops import conv3x3 as cv

    tree = tree_to(random_lora(ucfg, seed=SEED + 70,
                               replace=lora_lib.UNET_EXTENDED_TARGET_REPLACE), "cuda")
    routed = per_step["conv3x3"]
    old = (pipe.unet_lora, pipe.materialize_lora)
    pipe.unet_lora, pipe.materialize_lora = tree, True
    try:
        copies = []
        for _ in range(2):
            before, launched = cv.tap_major_copies, counts()
            imgs = pipe("photo of sks", num_inference_steps=1, seed=5, guidance_scale=GUIDANCE,
                        height=IMAGE, width=IMAGE, output_type="uint8")
            torch.cuda.synchronize()
            launched = {k: v - launched[k] for k, v in counts().items()}
            copies.append(cv.tap_major_copies - before)
            want = dict(per_step, lora_dense=0, group_norm=pipe_norms(pipe, 1))
            if launched != want:
                fail(f"a merged switched request launched {launched}, want {want}")
    finally:
        pipe.unet_lora, pipe.materialize_lora = old
        pipe.invalidate_merged_cache()
    log(f"merged serving, LoRA on the resnet convs too: tap-major copies {copies[0]} in the "
        f"first request (want {routed}, one a routed conv), {copies[1]} in the second (want 0); "
        f"image std {imgs.std():.2f}")
    if copies != [routed, 0]:
        fail(f"tap-major copies of the merged conv weights per request {copies}, "
             f"want [{routed}, 0]")
    if not imgs.std() > 0:
        fail("a merged switched image is constant")
    return {"tap_major_copies": copies}


def switched_launches(pipe, ucfg):
    """Launches a step with both switches on: (UNet step, train step,
    checkpointed train step)."""
    from diffusion_finetuning_tpu_torch.ops import flash_attention as fa

    side = IMAGE // pipe.vae_scale_factor
    k5 = sum(unet_conv3x3_calls(ucfg, 2, side).values())
    k4 = {bh: sum(n for sq, skv, d, n in FLASH_SHAPES
                  if fa.use_head_pack(HEAD_PACK, bh, sq, skv, d, 2))
          for bh in (FLASH_BH, FLASH_BWD_BH)}
    unet_step = want_counts(flash_attention_fwd_packed=k4[FLASH_BH], conv3x3=k5,
                            lora_dense=LORA_PER_STEP)
    train_step = want_counts(flash_attention_fwd_packed=k4[FLASH_BWD_BH], conv3x3=k5,
                             flash_attention_bwd=FLASH_PER_STEP, lora_dense=LORA_PER_STEP)
    # checkpointing recomputes a block in the backward only where autograd
    # needs its activations: not in the first resnet, whose input (conv_in
    # of the latents) and frozen weights need no gradient -- the LoRA'd
    # layers start after it.  Its routed convs run once.
    first = sum(unet_conv3x3_calls(ucfg, 1, side, only="down_blocks_0_resnets_0").values())
    train_ckpt = {name: n * (1 if name == "flash_attention_bwd" else 2)
                  for name, n in train_step.items()}
    train_ckpt["conv3x3"] -= first
    return unet_step, train_step, train_ckpt


def phase_switched(pipe, ucfg, vcfg, tcfg, sds, lora_cpu, lora_dev, unet_ref, ref_pipe,
                   batch, train_ref, profile_dir=None, device="cuda"):
    """Phase 6: both switches on for the UNet step check, img2img (the
    reference and the requests) and training; off again after."""
    unet_step, train_step, train_ckpt = switched_launches(pipe, ucfg)
    log(f"phase 6 launches a step: UNet {unet_step}; train {train_step}; "
        f"checkpointed train {train_ckpt}")
    set_switches(True)
    try:
        out = {"unet_step": phase_switched_unet_step(pipe, lora_dev, unet_ref, unet_step,
                                                     profile_dir)}
        out["img2img_reference"] = phase_img2img_reference(pipe, ref_pipe, lora_cpu, lora_dev)
        img_launches, out["img2img"] = phase_img2img(pipe, lora_dev, unet_step)
        out["merged_conv_cache"] = phase_merged_conv_cache(pipe, ucfg, unet_step)
        out["train_reference"], _ = phase_train_reference(
            pipe, ucfg, vcfg, tcfg, sds, lora_cpu, batch, device=device, cpu_ref=train_ref)
        train_launches, out["train"] = phase_train(
            pipe, ucfg, lora_cpu, batch, train_step, profile_dir=profile_dir, device=device,
            steps=4, warmup=1, label="train_step_switched", ckpt_want=train_ckpt)
    finally:
        set_switches(False)
    return {"img2img": img_launches, "train_switched": train_launches}, out


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

GRAPH_REPEATS = 5  # timed calls of each graphed path, and of each eager train path (10 before
# phase 12 joined the script: its walls repeat within 3%, PERF.md §5)
# timed eager requests of each serving path: one takes 2-4 s, host-bound, and
# ten of every path would cost 2-3 minutes on a slow host (the whole script
# took 956 s of its 1200 on one, with 5)
EAGER_REQUESTS = 3
TRAIN_SPDS = (1, 4)


def walls_ms(fn, n):
    """Host-clock ms of ``n`` calls of fn(), each ending in a synchronize."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def spread(ms):
    s = sorted(ms)
    return {"median": s[len(s) // 2], "min": s[0], "max": s[-1]}


def graphed_path(label, eager, graphed, same, per_call, units, profile_dir=None,
                 eager_repeats=GRAPH_REPEATS, graphed_repeats=GRAPH_REPEATS):
    """One path eager and graphed: ``eager()`` / ``graphed()`` run one call
    (a request, or a dispatch of ``units`` train steps); ``same()`` checks,
    after the first call of each, that they agree bit for bit.  The first
    graphed call warms up, captures and replays: the launch counters, set to
    0 just before it, must read twice ``per_call`` (warm-up and capture)
    after it and again after the timed replays.  Then walls, peak memory and
    one profiled call of each; a traced replay must run ``per_call`` of
    the port's kernels on the device (``profile_replay``)."""
    import torch

    from diffusion_finetuning_tpu_torch.ops import conv3x3 as cv

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e_walls = walls_ms(eager, eager_repeats)
    e_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    copies = cv.tap_major_copies
    t0 = time.perf_counter()
    graphed()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    captured = counts()
    # the eager runs cached every cacheable tap-major weight: copies now are
    # an inference tensor's, made by the warm-up and recorded by the capture
    # (half of them redone by every replay)
    copies = cv.tap_major_copies - copies
    equal = same()
    g_walls = walls_ms(graphed, graphed_repeats)
    replayed = counts()
    g_peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    prof_e = profile_step(eager, f"{label}_eager", None, cpu=False, warm=False)
    prof_g = profile_replay(graphed, f"{label}_graphed", profile_dir, per_call)
    want2 = {k: 2 * n for k, n in per_call.items()}
    e_med, g_med = spread(e_walls)["median"], spread(g_walls)["median"]
    # idle share: 1 - busy / the untraced median wall (tracing slows the
    # eager launches, so the traced call's own wall overstates its idling)
    e_idle, g_idle = 1 - prof_e["busy_ms"] / e_med, 1 - prof_g["busy_ms"] / g_med
    row = {"path": label, "units": units, "equal": equal,
           "eager_ms": spread(e_walls), "graphed_ms": spread(g_walls),
           "eager_units_per_s": units * 1e3 / e_med, "graphed_units_per_s": units * 1e3 / g_med,
           "first_graphed_call_s": first_s,
           "eager_busy_ms": prof_e["busy_ms"], "graphed_busy_ms": prof_g["busy_ms"],
           "eager_idle_share": e_idle, "graphed_idle_share": g_idle,
           "eager_idle_share_traced": prof_e["idle_share"],
           "graphed_idle_share_traced": prof_g["idle_share"],
           "eager_kernels": prof_e["kernels"], "graphed_kernels_a_replay": prof_g["kernels"],
           "launches_at_capture": captured, "ours_a_replay": prof_g["launches"],
           "tap_major_copies_in_graph": copies,
           "eager_by_kind_ms": prof_e["by_kind_ms"], "graphed_by_kind_ms": prof_g["by_kind_ms"],
           "eager_peak_bytes": e_peak, "graphed_peak_bytes": g_peak,
           "reserved_bytes": reserved}
    log(f"graphed {label}: equal to eager {equal}; wall ms eager {e_med:.3f} "
        f"({spread(e_walls)['min']:.3f}-{spread(e_walls)['max']:.3f}), graphed {g_med:.3f} "
        f"({spread(g_walls)['min']:.3f}-{spread(g_walls)['max']:.3f}), "
        f"x{e_med / g_med:.2f}; {units} a call: {row['eager_units_per_s']:.3f} -> "
        f"{row['graphed_units_per_s']:.3f} a s; first graphed call {first_s:.2f} s; "
        f"busy ms {prof_e['busy_ms']:.3f} -> {prof_g['busy_ms']:.3f}, idle share "
        f"{e_idle:.3f} -> {g_idle:.3f} (traced call {prof_e['idle_share']:.3f} -> "
        f"{prof_g['idle_share']:.3f}); kernels {prof_e['kernels']} "
        f"eager, {prof_g['kernels']} a replay; peak GiB {e_peak / 2**30:.3f} -> "
        f"{g_peak / 2**30:.3f} (reserved {reserved / 2**30:.3f})")
    log(f"  launches at capture {captured} (want {want2}), after the replays {replayed}; "
        f"the port's kernels in one profiled replay {prof_g['launches']} (want {per_call}); "
        f"tap-major copies in the first graphed call {copies}")
    if not equal:
        fail(f"the graphed {label} differs from the eager one")
    if captured != want2 or replayed != want2:
        fail(f"the graphed {label} launched {captured} at capture and {replayed} after the "
             f"replays, want {want2} both")
    return row


TRACE_ATTEMPTS = 3


def profile_replay(fn, label, out_dir, per_call):
    """``profile_step`` of one graphed call, which must run ``per_call`` of
    the port's kernels on the device.  A trace can lose activity records
    (on the H100 one trace of a 512^2 txt2img replay saw 61,888 of its
    62,307 device kernels, and 1,599 of its 1,600 K1 launches), and a lost
    record can only lower a count: so the call is traced again, at most
    TRACE_ATTEMPTS times, until one trace sees exactly ``per_call``.  Fatal
    if a trace sees more of any kernel, or if none sees all of them."""
    seen = []
    for attempt in range(TRACE_ATTEMPTS):
        prof = profile_step(fn, label, out_dir, cpu=False, warm=attempt == 0)
        seen.append((prof["kernels"], prof["launches"]))
        if any(prof["launches"][k] > n for k, n in per_call.items()):
            fail(f"a replay of the graphed {label} ran {prof['launches']}, want {per_call}")
        if prof["launches"] == per_call:
            if attempt:
                log(f"  traces of {label} before the complete one saw (device kernels, "
                    f"the port's launches) {seen[:-1]}: records lost, traced again")
            return prof
    fail(f"no trace of a replay of the graphed {label} saw {per_call}: (device kernels, the "
         f"port's launches) of each {seen}")


def phase_graphed_serving(pipe, lora_dev, per_step, profile_dir=None):
    """512^2 txt2img, 50 DDIM steps, CFG 7.5, batches 1 and 2, LoRA merged
    and dynamic, eager (``cuda_graphs = False``) and through the request's
    CUDA graph: each graphed image equal to the eager one."""
    import torch

    rows = []
    pipe.unet_lora = lora_dev
    for mat in (True, False):
        pipe.materialize_lora = mat
        for prompt, seed in (("a photo of sks", 1), (["photo of sks", "a photo of sks person"],
                                                     [3, 4])):
            b = 1 if isinstance(prompt, str) else len(prompt)
            kw = dict(seed=seed, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                      height=IMAGE, width=IMAGE, output_type="device")
            out = {}

            def run(graphs):
                old, pipe.cuda_graphs = pipe.cuda_graphs, graphs
                try:
                    out[graphs] = pipe(prompt, **kw)
                finally:
                    pipe.cuda_graphs = old

            per_call = {k: n * STEPS for k, n in per_step.items()
                        if k != "lora_dense" or not mat}
            per_call["group_norm"] = pipe_norms(pipe, STEPS)
            label = f"txt2img_b{b}_{'merged' if mat else 'dynamic'}"
            rows.append(graphed_path(
                label, lambda: run(False), lambda: run(True),
                lambda: torch.equal(out[False], out[True]), want_counts(**per_call), b,
                profile_dir if (b, mat) == (1, False) else None, EAGER_REQUESTS))
            if not all(float(im.float().std()) > 0 for im in out[True]):
                fail(f"a graphed {label} image is constant")
    return rows


def phase_graphed_img2img(pipe, lora_dev, per_step):
    """Phase 6's img2img request (512^2, strength 0.75: 38 UNet steps,
    both switches on, dynamic LoRA), eager and graphed."""
    import torch

    from diffusion_finetuning_tpu_torch.pipelines.pipeline import img2img_start

    pipe.unet_lora, pipe.materialize_lora = lora_dev, False
    image = init_image(IMAGE)
    out = {}

    def run(graphs):
        old, pipe.cuda_graphs = pipe.cuda_graphs, graphs
        try:
            out[graphs] = pipe.img2img("a photo of sks", image, strength=STRENGTH,
                                       num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                                       seed=1, output_type="device")
        finally:
            pipe.cuda_graphs = old

    unet_steps = STEPS - img2img_start(STEPS, STRENGTH)
    per_call = {k: n * unet_steps for k, n in per_step.items()}
    per_call["group_norm"] = pipe_norms(pipe, unet_steps, encode=True)
    return graphed_path("img2img_switched", lambda: run(False), lambda: run(True),
                        lambda: torch.equal(out[False], out[True]), per_call, 1,
                        eager_repeats=EAGER_REQUESTS)


def phase_graphed_train(pipe, lora_cpu, per_step, label, profile_dir=None):
    """The train step of phase 5 (512^2, batch 1, AdamW, clip 1.0) at spd 1
    (``jit_train_step``) and spd 4 (``multi_step``): eager steps from one
    state against the graphed ones from an equal state, with generators of
    one seed; after the first call the losses and the whole state (LoRA
    masters, moments, counts) must be equal bit for bit."""
    import torch

    from diffusion_finetuning_tpu_torch.models.schedulers import DDPMScheduler, SchedulerConfig
    from diffusion_finetuning_tpu_torch.training.optim import ParamGroup, multi_group_optimizer
    from diffusion_finetuning_tpu_torch.training.train_step import (
        TrainablePartition, build_train_step, carried_tensors, init_train_state,
        jit_train_step, multi_step, stack_batches)

    batches = [train_batch(pipe.tokenizer, seed=SEED + 40 + i) for i in range(max(TRAIN_SPDS))]
    rows = []
    for spd in TRAIN_SPDS:
        opt = multi_group_optimizer({"unet_lora": ParamGroup(lr=TRAIN_LR)}, max_grad_norm=1.0)
        step = build_train_step(unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae,
                                scheduler=DDPMScheduler(SchedulerConfig()), optimizer=opt,
                                partition=TrainablePartition(unet_lora=True))
        states = [init_train_state(opt, unet_lora=lora_cpu) for _ in range(2)]
        gens = [torch.Generator(device="cuda").manual_seed(SEED + 51) for _ in range(2)]
        fused = jit_train_step(step) if spd == 1 else multi_step(step, spd)
        group = batches[:spd]
        stacked = group[0] if spd == 1 else stack_batches(group)
        losses = {}

        first = {}  # the first call's losses and state, eager and graphed

        def eager():
            loss = torch.stack([step(states[0], b, gens[0])[1]["loss"] for b in group])
            if "eager" not in first:
                first["eager"] = (loss, [t.clone() for t in carried_tensors(states[0])])

        def graphed():
            loss = fused(states[1], stacked, gens[1])[1]["loss"].reshape(-1)
            losses["graphed"] = loss
            if "graphed" not in first:
                first["graphed"] = (loss, [t.clone() for t in carried_tensors(states[1])])

        def same():
            (le, se), (lg, sg) = first["eager"], first["graphed"]
            return torch.equal(le, lg) and all(torch.equal(a, b) for a, b in zip(se, sg))

        rows.append(graphed_path(f"{label}_spd{spd}", eager, graphed, same,
                                 {k: n * spd for k, n in per_step.items()}, spd,
                                 profile_dir if spd == 1 else None))
        if not all(math.isfinite(float(x)) for x in losses["graphed"]):
            fail(f"a graphed {label} loss is not finite")
    return rows


def phase_graphed(pipe, ucfg, lora_cpu, lora_dev, profile_dir=None):
    """Phase 7: the paths of phases 4-6 through their CUDA graphs, each
    against its eager run."""
    switched_unet_step, switched_train_step, _ = switched_launches(pipe, ucfg)
    rows = phase_graphed_serving(pipe, lora_dev, want_counts(
        flash_attention_fwd=FLASH_PER_STEP, lora_dense=LORA_PER_STEP), profile_dir)
    rows += phase_graphed_train(pipe, lora_cpu, want_counts(
        flash_attention_fwd=FLASH_PER_STEP, flash_attention_bwd=FLASH_PER_STEP,
        lora_dense=LORA_PER_STEP), "train", profile_dir)
    set_switches(True)
    try:
        rows.append(phase_graphed_img2img(pipe, lora_dev, switched_unet_step))
        rows += phase_graphed_train(pipe, lora_cpu, switched_train_step, "train_switched")
    finally:
        set_switches(False)
    check_no_fallbacks("phase 7")
    launches = {}
    for r in rows:
        for k, n in r["launches_at_capture"].items():
            launches[k] = launches.get(k, 0) + n
    return launches, rows


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

SERVE_STEPS = 30
SERVE_SCHEDULERS = ("dpm", "euler_a", "ddim")  # the server's default first
SERVE_MAX_BATCH = 4
SERVE_REQUESTS = 12
SERVE_THREADS = 4
# bursts run until one captures no graph (its requests/s is the warm rate):
# which batch sizes a burst forms depends on the threads' interleaving
SERVE_BURSTS = 4
TEXT_LORA_PER_ENCODE = 48  # 12 CLIP layers x (k, v, q, out) through K2 when dynamic
TOKEN_A, TOKEN_B = "<sks-a>", "<sks-b>"


def random_text_lora(tcfg, seed):
    """A rank-4 text-encoder LoRA tree (bf16, CPU) with a non-zero up."""
    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.models.clip_text import text_encoder_lora_targets

    g = torch.Generator().manual_seed(seed)
    tree = lora_lib.inject_trainable_lora(text_encoder_lora_targets(tcfg), g, r=LORA_RANK,
                                          dtype=torch.bfloat16)
    for _, leaf in lora_lib.lora_leaves(tree):
        leaf["up"] = (torch.randn(leaf["up"].shape, generator=g) * LORA_UP_STD).bfloat16()
    return tree


def phase_model_dir(pipe, tmp, name="sd15"):
    """The pipe written with ``save_pretrained`` in bf16 into ``tmp``/``name``
    and read back with ``from_pretrained``: every tensor equal, the same
    configs.  Returns the loaded pipe."""
    import torch

    from diffusion_finetuning_tpu_torch.models.hf_export import save_pretrained
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline

    d = os.path.join(tmp, name)
    t0 = time.perf_counter()
    save_pretrained(pipe, d, dtype=torch.bfloat16)
    write_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)
    t0 = time.perf_counter()
    loaded = StableDiffusionPipeline.from_pretrained(d, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n = 0
    for part in ("unet", "vae", "text_encoder"):
        a, b = getattr(pipe, part).state_dict(), getattr(loaded, part).state_dict()
        if a.keys() != b.keys():
            fail(f"from_pretrained's {part} has other tensors than the pipe's")
        for k, v in a.items():
            n += 1
            if not torch.equal(v, b[k]):
                fail(f"from_pretrained's {part}.{k} differs from the pipe's")
    configs = ("unet_config", "vae_config", "text_config", "scheduler_config")
    if [getattr(loaded, c) for c in configs] != [getattr(pipe, c) for c in configs]:
        fail("from_pretrained read other configs than the pipe's")
    log(f"model dir {name}: save_pretrained bf16 {size / 2**30:.3f} GiB in {write_s:.2f} s, "
        f"from_pretrained {load_s:.2f} s; {n} tensors equal")
    return loaded, {"bytes": size, "write_s": write_s, "load_s": load_s, "tensors": n}


def phase_lora_files(pipe, ucfg, tcfg, tmp):
    """Adapter A, a UNet and text-encoder rank-4 LoRA and one TI token in
    one safetensors (``save_safeloras_with_embeds``), and adapter B, a
    ``.pt`` triple (``save_all(safe_form=False)``), read back: the
    safetensors bit-equal, the ``.pt`` lists equal to the fp16-rounded
    trees, B's embed in fp32."""
    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.io import safetensors_io

    ut = pipe.lora_targets("unet", lora_lib.DEFAULT_TARGET_REPLACE)
    tt = pipe.lora_targets("text_encoder", lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
    g = torch.Generator().manual_seed(SEED + 60)
    dim = tcfg.hidden_size
    trees = {"A": (random_lora(ucfg, SEED + 61), random_text_lora(tcfg, SEED + 62),
                   {TOKEN_A: (torch.randn(dim, generator=g) * 0.02).bfloat16()}),
             "B": (random_lora(ucfg, SEED + 63), random_text_lora(tcfg, SEED + 64),
                   {TOKEN_B: torch.randn(dim, generator=g) * 0.02})}
    paths = {"A": os.path.join(tmp, "adapter_a.safetensors"),
             "B": os.path.join(tmp, "adapter_b.pt")}
    ua, ta, ea = trees["A"]
    lora_lib.save_safeloras_with_embeds(
        {"unet": (ua, ut, lora_lib.DEFAULT_TARGET_REPLACE),
         "text_encoder": (ta, tt, lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)}, ea, paths["A"])
    ub, tb, eb = trees["B"]
    lora_lib.save_all(ub, tb, ut, tt, eb, paths["B"], safe_form=False)

    tensors, meta = safetensors_io.read_safetensors(paths["A"])
    loras = safetensors_io.parse_safeloras(tensors, meta)
    for name, tree, targets in (("unet", ua, ut), ("text_encoder", ta, tt)):
        flat, ranks, _ = loras[name]
        if set(ranks) != {LORA_RANK} or not all(
                torch.equal(a, b) for a, b in zip(flat, lora_lib.lora_tree_to_flat(tree, targets))):
            fail(f"adapter A's {name} pairs do not read back bit for bit")
    if not torch.equal(safetensors_io.parse_safeloras_embeds(tensors, meta)[TOKEN_A], ea[TOKEN_A]):
        fail("adapter A's TI embed does not read back bit for bit")
    for path, tree, targets in ((paths["B"], ub, ut),
                                (lora_lib._text_lora_path(paths["B"]), tb, tt)):
        got = torch.load(path, weights_only=True)
        want = lora_lib.lora_tree_to_flat(tree, targets)
        if not all(a.dtype == torch.float16 and torch.equal(a, b.half())
                   for a, b in zip(got, want)) or len(got) != len(want):
            fail(f"{path} does not hold the fp16-rounded pairs")
    ti = torch.load(lora_lib._ti_lora_path(paths["B"]), weights_only=True)
    if not torch.equal(ti[TOKEN_B], eb[TOKEN_B].float()):
        fail("adapter B's TI embed does not read back")
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    log(f"LoRA files: A {sizes['A']} bytes (safetensors, {len(tensors)} tensors), "
        f"B {sizes['B']} bytes (.pt) + text encoder + TI side-cars; read back equal")
    return paths


def _param_copy(pipe):
    """Resolve the installed trees (merged where they changed) and copy
    them into the request graphs' static buffers, each part timed on the
    host clock around work ending in a synchronize: (merge ms, copy ms,
    bytes copied); the copy is None before the buffers exist."""
    import torch

    from diffusion_finetuning_tpu_torch.pipelines.pipeline import param_signature

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = pipe._generation_params()
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) * 1e3
    sig, flat = param_signature(params)
    bufs = None if pipe._graphs is None else pipe._graphs.params.get(sig)
    if bufs is None:
        return merge_ms, None, 0
    t0 = time.perf_counter()
    copied = bufs.fill(flat)
    torch.cuda.synchronize()
    return merge_ms, (time.perf_counter() - t0) * 1e3, copied


def phase_swaps(pipe, paths):
    """``patch_pipe`` with A, then B, then ``tune_lora_scale_pipe`` at one
    request key (512^2, 30 steps, "dpm", batch 1): one graph captured, each
    image equal to the eager request, and the memory after each swap not
    grown by a merged set: neither what stays allocated nor the peak from
    the swap through its request (merge, copy and replay), which must stay
    under the first swap's peak (that of the capture) plus half a set, and
    within half a set of what was allocated before the swap (the superseded
    set is freed before the next is built)."""
    import torch

    from diffusion_finetuning_tpu_torch.pipelines.pipeline import patch_pipe, tune_lora_scale_pipe

    pipe.cuda_graphs, pipe.materialize_lora = True, True
    kw = dict(num_inference_steps=SERVE_STEPS, height=IMAGE, width=IMAGE, scheduler="dpm",
              guidance_scale=GUIDANCE, seed=1, output_type="device")
    prompt = f"a photo of {TOKEN_A} person"
    swaps = [("patch A", lambda: patch_pipe(pipe, paths["A"], patch_text=True, patch_ti=True)),
             ("patch B", lambda: patch_pipe(pipe, paths["B"], patch_text=True, patch_ti=True)),
             ("tune 0.6", lambda: tune_lora_scale_pipe(pipe, 0.6))]
    rows, images = [], []
    for label, swap in swaps:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        swap()
        torch.cuda.synchronize()
        install_ms = (time.perf_counter() - t0) * 1e3
        merge_ms, copy_ms, copied = _param_copy(pipe)
        t0 = time.perf_counter()
        img = pipe(prompt, **kw)
        torch.cuda.synchronize()
        request_ms = (time.perf_counter() - t0) * 1e3
        peak, allocated = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        pipe.cuda_graphs = False
        eager = pipe(prompt, **kw)
        pipe.cuda_graphs = True
        equal = torch.equal(img, eager)
        rows.append(dict(swap=label, install_ms=install_ms, merge_ms=merge_ms, copy_ms=copy_ms,
                         copied_bytes=copied, request_ms=request_ms, peak_bytes=peak,
                         before_bytes=before, allocated_bytes=allocated, graphs=len(pipe._graphs.graphs),
                         equal=equal))
        images.append(img)
        copy = "buffers made by the capture" if copy_ms is None else (
            f"copy {copy_ms:.3f} ms ({copied / 2**30:.3f} GiB)")
        log(f"swap {label}: install {install_ms:.1f} ms, merge {merge_ms:.1f} ms, {copy}; "
            f"request {request_ms:.1f} ms; peak {peak / 2**30:.3f} GiB, allocated "
            f"{allocated / 2**30:.3f} GiB; graphs {rows[-1]['graphs']}; equal to eager {equal}")
        if not equal:
            fail(f"the graphed request after {label} differs from the eager one")
    merged = sum(w.numel() * w.element_size() for w in pipe._generation_params()[0].values())
    if {r["graphs"] for r in rows} != {1}:
        fail(f"the swaps captured {rows[-1]['graphs']} graphs, want 1")
    if any(torch.equal(a, b) for a, b in zip(images, images[1:])):
        fail("a swap left the image unchanged")
    grown = max(r["allocated_bytes"] for r in rows[1:]) - rows[1]["allocated_bytes"]
    peak_over = max(r["peak_bytes"] for r in rows[1:]) - rows[0]["peak_bytes"]
    held = max(r["peak_bytes"] - r["before_bytes"] for r in rows[1:])
    log(f"merged set {merged / 2**30:.3f} GiB; allocated grew {grown / 2**30:.3f} GiB over "
        f"the swaps after the first; their peak is {peak_over / 2**30:.3f} GiB over the "
        f"first swap's and at most {held / 2**30:.3f} GiB over what was allocated before "
        "each")
    if grown >= merged // 2:
        fail("the memory grew by a merged set per swap")
    if peak_over >= merged // 2 or held >= merged // 2:
        fail("a swap's peak held a second merged set")
    pipe.unet_lora = pipe.text_encoder_lora = None
    pipe.text_params = {}
    return rows, merged


def _burst(server, requests):
    """``requests`` [(prompt, seed, scheduler, adapter)] from SERVE_THREADS
    threads released together, request i from thread i % SERVE_THREADS;
    returns (images in request order, latency s each from its submit to its
    future's resolution, wall s of the burst)."""
    import threading

    out, lat = [None] * len(requests), [None] * len(requests)
    start = threading.Barrier(SERVE_THREADS + 1)

    def client(t):
        start.wait()
        mine = []
        for i, (p, s, sch, a) in enumerate(requests):
            if i % SERVE_THREADS != t:
                continue
            t0 = time.perf_counter()
            fut = server.submit(p, steps=SERVE_STEPS, height=IMAGE, width=IMAGE,
                                guidance_scale=GUIDANCE, scheduler=sch, seed=s, adapter=a)
            fut.add_done_callback(
                lambda f, i=i, t0=t0: lat.__setitem__(i, time.perf_counter() - t0))
            mine.append((i, fut))
        for i, fut in mine:
            out[i] = fut.result(timeout=600)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(SERVE_THREADS)]
    for th in threads:
        th.start()
    start.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    for _ in range(100):  # the last done callbacks may still be running
        if all(x is not None for x in lat):
            break
        time.sleep(0.01)
    if any(th.is_alive() for th in threads) or any(o is None for o in out + lat):
        fail("a served request did not come back")
    return out, lat, wall


def _graph_launches(keys, per_step, pipe):
    """The wrapper launches of capturing the request graphs ``keys`` of
    ``pipe``: twice (warm-up and capture) each UNet step's K1 calls, and
    K2's where the UNet LoRA is dynamic, plus the text encoder's K2 calls
    where its LoRA is, and the request's GroupNorms."""
    total = want_counts()
    for key in keys:
        steps, sig = key[1], key[7]
        parts = {k[0][0] for k in sig}
        total["flash_attention_fwd"] += 2 * per_step["flash_attention_fwd"] * steps
        total["group_norm"] += 2 * pipe_norms(pipe, steps)
        total["lora_dense"] += 2 * (per_step["lora_dense"] * steps * (1 in parts)
                                    + TEXT_LORA_PER_ENCODE * (3 in parts))
    return total


def _key_label(key):
    """The scheduler, batch and LoRA route of a request graph's key."""
    parts = {k[0][0] for k in key[7]}
    lora = "dynamic" if 1 in parts else "merged" if 0 in parts else "no LoRA"
    return f"{key[4]} b{key[5]} {lora}"


def phase_server(pipe, paths, per_step):
    """``GenerationServer(pipe, max_batch=4)`` with A (merged) and B
    (dynamic: K2) registered: bursts of 12 requests from 4 threads
    (adapters None, A, B with "dpm", "euler_a", "ddim"; 512^2, 30 steps,
    CFG 7.5, distinct seeds), the first capturing the graphs it needs, until
    one captures none (at most SERVE_BURSTS).  The
    launch counters, set to 0 just before each burst, must read what the
    burst's new graphs capture (replays run no wrapper); every image is
    within PIPE_MEAN_ABS of the same request alone at batch 1."""
    import numpy as np
    import torch

    from diffusion_finetuning_tpu_torch.serving import GenerationServer

    server = GenerationServer(pipe, max_batch=SERVE_MAX_BATCH)
    server.register_adapter("A", paths["A"])
    server.register_adapter("B", paths["B"], materialize=False)
    adapters = (None, "A", "B")
    prompts = {None: "a photo of sks person", "A": f"a photo of {TOKEN_A}",
               "B": f"a portrait of {TOKEN_B}"}
    rows, launched = [], {}
    try:
        for burst in range(1, SERVE_BURSTS + 1):
            requests = [(prompts[adapters[i % 3]], 100 * burst + i, SERVE_SCHEDULERS[i % 3],
                         adapters[i % 3]) for i in range(SERVE_REQUESTS)]
            before = set(pipe._graphs.graphs) if pipe._graphs is not None else set()
            torch.cuda.synchronize()
            reset_counts()
            images, lat, wall = _burst(server, requests)
            torch.cuda.synchronize()
            got = counts()
            new = [k for k in pipe._graphs.graphs if k not in before]
            want = _graph_launches(new, per_step, pipe)
            launched[f"server_burst{burst}"] = got
            arrays = [np.asarray(im) for im in images]
            diffs = []
            for (p, s, sch, a), img in zip(requests, arrays):
                alone = pipe(p, seed=s, num_inference_steps=SERVE_STEPS, height=IMAGE,
                             width=IMAGE, guidance_scale=GUIDANCE, scheduler=sch,
                             adapter_params=server._adapter_params(a), output_type="uint8")[0]
                diffs.append(float(np.abs(img.astype(np.float32) - alone).mean()) / 255)
            lat_s = sorted(lat)
            row = dict(burst=burst, requests=len(requests), wall_s=wall,
                       requests_per_s=len(requests) / wall,
                       latency_p50_s=lat_s[len(lat_s) // 2],
                       latency_p95_s=lat_s[min(len(lat_s) - 1, int(0.95 * len(lat_s)))],
                       graphs_captured=len(new),
                       capture_s={_key_label(k): pipe._graphs.graphs[k].capture_s
                                  for k in new},
                       batches=sorted(k[5] for k in new), launches=got, want=want,
                       max_mean_abs_diff=max(diffs))
            rows.append(row)
            log(f"server burst {burst}: {len(requests)} requests in {wall:.2f} s, "
                f"{row['requests_per_s']:.3f} requests/s, latency p50 "
                f"{row['latency_p50_s']:.3f} s p95 {row['latency_p95_s']:.3f} s; "
                f"{len(new)} graphs captured (warm-up + capture s: "
                f"{ {k: round(v, 2) for k, v in row['capture_s'].items()} }); launches {got} "
                f"(want {want}); vs alone at batch 1: max mean |diff| {max(diffs):.3e} "
                f"(limit {PIPE_MEAN_ABS})")
            if got != want:
                fail(f"server burst {burst} launched {got}, want {want}")
            if not max(diffs) <= PIPE_MEAN_ABS:
                fail(f"a served image differs from its lone run by {max(diffs):.3e}")
            if not all(a.shape == (IMAGE, IMAGE, 3) and a.std() > 0 for a in arrays):
                fail("a served image is constant or misshapen")
            if burst > 1 and not new:
                break  # a warm burst: every graph it needs was captured before
        if not any(_key_label(k).endswith("dynamic") for k in pipe._graphs.graphs):
            fail("no server graph ran adapter B's dynamic LoRA")
    finally:
        server.close()
    return launched, rows


def phase_serving_entry(pipe, ucfg, tcfg, per_step, tmp):
    """Phase 8: a model directory and LoRA/TI files in, swaps without a
    capture, per-request adapters and schedulers out of the server.  The
    directory stays in ``tmp`` (phase 9 trains from it)."""
    t0 = time.time()
    loaded, model_dir = phase_model_dir(pipe, tmp)
    paths = phase_lora_files(loaded, ucfg, tcfg, tmp)
    log(f"phase 8 files: {time.time() - t0:.1f} s")
    t0 = time.time()
    swaps, merged = phase_swaps(loaded, paths)
    log(f"phase 8 swaps: {time.time() - t0:.1f} s")
    t0 = time.time()
    launches, server = phase_server(loaded, paths, per_step)
    log(f"phase 8 server: {time.time() - t0:.1f} s")
    return launches, {"model_dir": model_dir, "swaps": swaps, "merged_set_bytes": merged,
                      "server": server}


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

TRAIN_IMAGES = 4
TI_STEPS = 8           # inversion steps (gradient accumulation 2: 4 updates)
TUNE_STEPS = 8
TRAINER_SPD = 4        # divides TRAINER_SAVE: one capture serves a phase
TRAINER_SAVE = 4
DB_STEPS = 8
WTI_STEPS = 8
CLASS_IMAGES = 2
CLASS_STEPS = 10
PTI_SERVE_STEPS = 20


def trainer_step_launches():
    """Wrapper launches of one train step of each trainer phase, from the
    code: every UNet attention call runs K1 forward (FLASH_PER_STEP).  K3
    runs where autograd built a flash node, i.e. where q, k or v needs a
    gradient: with a LoRA every call; in the TI phase (no LoRA, the
    gradient reaches the text only through the cross-attention K/V) every
    call but the first transformer block's attn1, whose input depends on
    the latents and the timestep alone.  K2 runs on every LoRA'd projection:
    the UNet's (LORA_PER_STEP) and, with the text LoRA, CLIP's
    (TEXT_LORA_PER_ENCODE)."""
    ti = want_counts(flash_attention_fwd=FLASH_PER_STEP,
                     flash_attention_bwd=FLASH_PER_STEP - 1)
    lora = want_counts(flash_attention_fwd=FLASH_PER_STEP, flash_attention_bwd=FLASH_PER_STEP,
                       lora_dense=LORA_PER_STEP + TEXT_LORA_PER_ENCODE)
    return ti, lora


def captured(per_step, steps, graphs=1):
    """Launches of capturing ``graphs`` graphs of ``steps`` steps each: the
    warm-up and the capture run the steps' wrappers; replays run none."""
    return {k: 2 * n * steps * graphs for k, n in per_step.items()}


def add_counts(*dicts):
    out = want_counts()
    for d in dicts:
        for k, n in d.items():
            out[k] += n
    return out


def train_images(folder, seed, n, side=IMAGE):
    """``n`` seeded ``side``^2 PNGs: smooth colour fields with noise."""
    import numpy as np
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side] / side
    for i in range(n):
        base = np.stack([np.sin(6 * xx + i), np.cos(5 * yy - i), xx * yy], -1)
        px = (base * 0.35 + 0.5 + rng.normal(0, 0.08, base.shape)) * 255
        Image.fromarray(np.clip(px, 0, 255).astype(np.uint8)).save(
            os.path.join(folder, f"a photo of sks_{i}.png"))


def check_phase_log(entry, label, want):
    """A trainer phase's dispatch summary: finite losses, the launches
    ``want``; prints its first dispatch s, steps/s after it, peak memory."""
    import numpy as np

    losses = np.asarray(entry["losses"])
    peak = "n/a" if entry["peak_bytes"] is None else f"{entry['peak_bytes'] / 2**30:.2f}"
    sps = entry["steps_per_s"]
    rate = "no replay" if sps is None else f"{sps:.3f} steps/s ({1e3 / sps:.1f} ms a step)"
    log(f"{label}: {entry['steps']} steps in {entry['wall_s']:.2f} s, first dispatch "
        f"(captures) {entry['first_dispatch_s']:.2f} s, then {rate}, "
        f"peak memory {peak} GiB; launches {entry['launches']} "
        f"(want {want}); losses {np.round(losses, 4).tolist()}")
    if not (losses.size == entry["steps"] and np.isfinite(losses).all()):
        fail(f"{label}: a loss is not finite")
    if entry["launches"] != want:
        fail(f"{label} launched {entry['launches']}, want {want}")
    return {k: entry[k] for k in ("steps", "wall_s", "first_dispatch_s", "steps_per_s",
                                  "peak_bytes", "launches")}


class _Tee:
    """stdout that is also kept, to read what a trainer printed."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        return sys.__stdout__.write(text)

    def flush(self):
        sys.__stdout__.flush()

    def text(self):
        return "".join(self.parts)


def phase_pti(model_dir, tmp):
    """``cli_lora_pti.train`` at 512^2 in bf16: 8 inversion steps
    (gradient accumulation 2) and 8 tuning steps with the text LoRA and
    continued inversion, rank 4, saves every 4 steps, 4 steps a graph."""
    import torch

    from diffusion_finetuning_tpu_torch import cli_lora_pti
    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.io import safetensors_io

    out = os.path.join(tmp, "pti")
    ti_step, lora_step = trainer_step_launches()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    pipe = cli_lora_pti.train(
        instance_data_dir=os.path.join(tmp, "instance"), pretrained_model_name_or_path=model_dir,
        output_dir=out, use_template="object", placeholder_tokens="<s1>|<s2>",
        initializer_tokens="<rand-0.017>|<zero>", seed=SEED, resolution=IMAGE,
        train_batch_size=1, max_train_steps_ti=TI_STEPS, max_train_steps_tuning=TUNE_STEPS,
        gradient_accumulation_steps=2, train_text_encoder=True, continue_inversion=True,
        lora_rank=LORA_RANK, save_steps=TRAINER_SAVE, steps_per_dispatch=TRAINER_SPD,
        mixed_precision="bf16")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    inv, tune = pipe.train_log
    row = {"wall_s": wall, "ti_step_launches": ti_step,
           "inversion": check_phase_log(inv, "PTI inversion",
                                        captured(ti_step, TRAINER_SPD)),
           "tuning": check_phase_log(tune, "PTI tuning", captured(lora_step, TRAINER_SPD))}
    want = add_counts(captured(ti_step, TRAINER_SPD), captured(lora_step, TRAINER_SPD))
    if got != want:
        fail(f"PTI launched {got}, want {want}")
    if inv["frozen_rows_changed"] != 0:
        fail(f"PTI inversion changed {inv['frozen_rows_changed']} frozen embedding rows")
    files = sorted(os.listdir(out))
    want_files = sorted([f"step_inv_{s}.safetensors" for s in range(4, TI_STEPS + 1, 4)]
                        + [f"step_{s}.safetensors" for s in range(4, TUNE_STEPS + 1, 4)])
    if files != want_files:
        fail(f"PTI wrote {files}, want {want_files}")
    for name in files:
        tensors, meta = safetensors_io.read_safetensors(os.path.join(out, name))
        loras = lora_lib.parse_safeloras(tensors, meta)
        embeds = lora_lib.parse_safeloras_embeds(tensors, meta)
        want_loras = set() if name.startswith("step_inv") else {"unet", "text_encoder"}
        if set(loras) != want_loras or set(embeds) != {"<s1>", "<s2>"} or not all(
                torch.isfinite(t.float()).all() for t in tensors.values()):
            fail(f"PTI checkpoint {name} holds {sorted(loras)} and {sorted(embeds)}")
    moved = max(v for vals in lora_lib.inspect_lora(pipe.unet_lora).values() for v in vals)
    text_moved = max(v for vals in lora_lib.inspect_lora(pipe.text_encoder_lora).values()
                     for v in vals)
    if not (moved > 0 and text_moved > 0):
        fail("PTI's LoRA did not move")
    row.update(files=files, unet_lora_moved=moved, text_lora_moved=text_moved)
    log(f"PTI: {wall:.1f} s; frozen rows bit-equal after inversion; checkpoints {files} parse; "
        f"LoRA moved (max mean |up down|: UNet {moved:.3e}, text {text_moved:.3e})")
    return pipe, got, row


def phase_pti_serving(pipe):
    """The returned PTI pipe serves one graphed 512^2 request with the
    learned tokens and LoRA, and the same request without the LoRA: finite,
    and different."""
    import numpy as np
    import torch

    prompt = "a photo of <s1> <s2>"
    args = dict(seed=SEED, num_inference_steps=PTI_SERVE_STEPS, height=IMAGE, width=IMAGE,
                guidance_scale=GUIDANCE, output_type="uint8")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with_lora = pipe(prompt, **args)[0]
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = pipe(prompt, **args)[0]
    replay_s = time.perf_counter() - t0
    unet_lora, text_lora = pipe.unet_lora, pipe.text_encoder_lora
    pipe.unet_lora = pipe.text_encoder_lora = None
    without = pipe(prompt, **args)[0]
    pipe.unet_lora, pipe.text_encoder_lora = unet_lora, text_lora
    torch.cuda.synchronize()
    got = counts()
    want = add_counts(captured(want_counts(flash_attention_fwd=FLASH_PER_STEP), PTI_SERVE_STEPS,
                               graphs=2), {"group_norm": 2 * 2 * pipe_norms(pipe, PTI_SERVE_STEPS)})
    diff = float(np.abs(with_lora.astype(np.float32) - without).mean()) / 255
    log(f"PTI pipe serving: first request (capture) {first_s:.2f} s, replay {replay_s:.3f} s; "
        f"mean |diff| against no LoRA {diff:.4f}; launches {got} (want {want})")
    if got != want:
        fail(f"the PTI pipe's requests launched {got}, want {want}")
    if not (with_lora.shape == (IMAGE, IMAGE, 3) and np.array_equal(with_lora, again)):
        fail("the PTI pipe's replay differs from its first request")
    if not diff > 0:
        fail("the learned LoRA and tokens change nothing in the PTI pipe's image")
    return got, {"first_s": first_s, "replay_s": replay_s, "mean_abs_diff_vs_no_lora": diff}


def dreambooth_args(model_dir, tmp, out):
    return [
        "--pretrained_model_name_or_path", model_dir,
        "--instance_data_dir", os.path.join(tmp, "instance"),
        "--instance_prompt", "a photo of sks person", "--with_prior_preservation",
        "--class_data_dir", os.path.join(tmp, "class"), "--class_prompt", "a photo of person",
        "--num_class_images", str(CLASS_IMAGES), "--sample_batch_size", str(CLASS_IMAGES),
        "--class_image_inference_steps", str(CLASS_STEPS), "--output_dir", out,
        "--resolution", str(IMAGE), "--train_batch_size", "1",
        "--max_train_steps", str(DB_STEPS), "--save_steps", str(TRAINER_SAVE),
        "--steps_per_dispatch", str(TRAINER_SPD), "--train_text_encoder",
        "--learning_rate", "1e-4", "--learning_rate_text", "5e-5", "--lr_warmup_steps", "0",
        "--lora_rank", str(LORA_RANK), "--mixed_precision", "bf16", "--seed", str(SEED),
        "--output_format", "both",
        "--full_state_checkpoint_dir", os.path.join(tmp, "dreambooth_state")]


def phase_dreambooth(model_dir, tmp):
    """``train_lora_dreambooth.main`` at 512^2 in bf16 with prior
    preservation (2 class images synthesised at 10 steps), the text LoRA
    and full-state checkpoints; then a second run from the step-4
    checkpoint, which must restore the saved state bit for bit and reach
    step 8; the .pt and safetensors outputs read back."""
    import contextlib
    import shutil

    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.io import safetensors_io
    from diffusion_finetuning_tpu_torch.models.clip_text import text_encoder_lora_targets
    from diffusion_finetuning_tpu_torch.models.unet import unet_lora_targets
    from diffusion_finetuning_tpu_torch.training import checkpoint as ckpt_lib
    from diffusion_finetuning_tpu_torch.training_scripts import train_lora_dreambooth as db

    _, lora_step = trainer_step_launches()
    out = os.path.join(tmp, "dreambooth")
    saved, restored = {}, {}
    real_save, real_restore = ckpt_lib.save_train_state, ckpt_lib.restore_train_state

    def save(ckpt_dir, state, step=None, keep=3):  # keeps what step 4 held
        if step == TRAINER_SAVE:
            saved.update({k: t.detach().clone()
                          for k, t in ckpt_lib.named_tensors(state).items()})
        return real_save(ckpt_dir, state, step=step, keep=keep)

    def restore(path, target):
        out_state = real_restore(path, target)
        restored.update({k: t.detach().clone()
                         for k, t in ckpt_lib.named_tensors(out_state).items()})
        return out_state

    ckpt_lib.save_train_state, ckpt_lib.restore_train_state = save, restore
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        first = db.main(db.parse_args(dreambooth_args(model_dir, tmp, out)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got_first = counts()
        state_dir = os.path.join(tmp, "dreambooth_state")
        shutil.rmtree(os.path.join(state_dir, f"step_{DB_STEPS}"))  # stopped after step 4
        tee = _Tee()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            second = db.main(db.parse_args(dreambooth_args(model_dir, tmp, out + "_resumed")))
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        got_second = counts()
    finally:
        ckpt_lib.save_train_state, ckpt_lib.restore_train_state = real_save, real_restore

    class_files = sorted(os.listdir(os.path.join(tmp, "class")))
    synth = add_counts(captured(want_counts(flash_attention_fwd=FLASH_PER_STEP), CLASS_STEPS),
                       {"group_norm": 2 * request_norms(*sd15_configs()[:2], CLASS_STEPS)})
    row = {"wall_s": wall, "resume_wall_s": resume_wall, "class_images": class_files,
           "train": check_phase_log(first["log"]["dispatch"], "DreamBooth",
                                    captured(lora_step, TRAINER_SPD)),
           "resumed": check_phase_log(second["log"]["dispatch"], "DreamBooth resumed",
                                      captured(lora_step, TRAINER_SPD)),
           "save_ms": first["log"]["save_ms"], "restore_ms": second["log"]["restore_ms"]}
    want_first = add_counts(synth, captured(lora_step, TRAINER_SPD))
    if got_first != want_first:
        fail(f"DreamBooth launched {got_first}, want {want_first} (class images + training)")
    if got_second != captured(lora_step, TRAINER_SPD):
        fail(f"the resumed DreamBooth run launched {got_second}")
    if len(class_files) != CLASS_IMAGES:
        fail(f"DreamBooth synthesised {class_files}")
    if "Resumed at step 4" not in tee.text() or second["log"]["resumed_at"] != TRAINER_SAVE:
        fail("the second DreamBooth run did not report 'Resumed at step 4'")
    if first["step"] != DB_STEPS or second["step"] != DB_STEPS:
        fail(f"DreamBooth reached steps {first['step']} and {second['step']}")
    if not saved or saved.keys() != restored.keys() or not all(
            saved[k].dtype == restored[k].dtype and torch.equal(saved[k], restored[k])
            for k in saved):
        fail("the restored DreamBooth state differs from the one saved at step 4")

    from diffusion_finetuning_tpu_torch.models import hf_loading

    ucfg = hf_loading.unet_config_from_hf(hf_loading.read_json(
        os.path.join(model_dir, "unet", "config.json")))
    tcfg = hf_loading.clip_config_from_hf(hf_loading.read_json(
        os.path.join(model_dir, "text_encoder", "config.json")))
    ut = lora_lib.filter_targets(unet_lora_targets(ucfg), lora_lib.DEFAULT_TARGET_REPLACE)
    tt = text_encoder_lora_targets(tcfg)
    params = second["params"]
    for name, tree, targets in (("lora_weight.pt", params["unet_lora"], ut),
                                ("lora_weight.text_encoder.pt", params["text_lora"], tt)):
        loaded = lora_lib.monkeypatch_lora(os.path.join(out + "_resumed", name), targets)
        for a, b in zip(lora_lib.lora_tree_to_flat(loaded, targets),
                        lora_lib.lora_tree_to_flat(tree, targets)):
            if not torch.equal(a, b.detach().cpu().half().float()):
                fail(f"DreamBooth's {name} does not read back as the fp16-rounded LoRA")
    tensors, meta = safetensors_io.read_safetensors(
        os.path.join(out + "_resumed", "lora_weight.safetensors"))
    loras = lora_lib.parse_safeloras(tensors, meta)
    if set(loras) != {"unet", "text_encoder"}:
        fail(f"DreamBooth's safetensors holds {sorted(loras)}")
    for name, tree, targets in (("unet", params["unet_lora"], ut),
                                ("text_encoder", params["text_lora"], tt)):
        flat, ranks, _ = loras[name]
        if set(ranks) != {LORA_RANK} or not all(
                torch.equal(a, b.detach().cpu()) for a, b in zip(
                    flat, lora_lib.lora_tree_to_flat(tree, targets))):
            fail(f"DreamBooth's safetensors {name} pairs differ from the trained LoRA")
    log(f"DreamBooth: {wall:.1f} s (class images {class_files}); resumed run {resume_wall:.1f} s "
        f"from step 4, restored state bit-equal ({len(saved)} tensors), full-state save ms "
        f"{[round(x, 1) for x in row['save_ms']]}, restore ms {row['restore_ms']:.1f}; "
        f".pt and safetensors outputs read back")
    return add_counts(got_first, got_second), row


def fp32_step_launches():
    """Wrapper launches of one fp32 DreamBooth step (the text LoRA on): the
    LoRA step of ``trainer_step_launches`` on the fp32 kernels' counters."""
    return want_counts(flash_attention_fwd_fp32=FLASH_PER_STEP,
                       flash_attention_bwd_fp32=FLASH_PER_STEP,
                       lora_dense_fp32=LORA_PER_STEP + TEXT_LORA_PER_ENCODE)


def fp32_step_scratch():
    """Bytes of the split copies the fp32 kernels allocate in one fp32
    DreamBooth step (batch 2: the UNet at the CFG step's shapes, the text
    encoder's 48 projections, K1's 32 forwards and K3's 32 backwards at BH
    16): the largest single call's and all calls' together, by kernel."""
    from diffusion_finetuning_tpu_torch.ops import flash_attention as fa
    from diffusion_finetuning_tpu_torch.ops import lora_matmul as lm

    calls = []
    for m, k, n, count in LORA_SHAPES + [TEXT_LORA_ROW]:
        bm = lm.plan_f32(m, n, k)[0]
        calls.append(("lora_dense_fp32", (m, k, n), count, 4 * lm.f32_scratch_floats(
            m, n, k, LORA_RANK, lm.f32_w_in_smem(m, k, bm))))
    for sq, skv, d, count in FLASH_SHAPES:
        calls.append(("flash_attention_fwd_fp32", (sq, skv, d), count,
                      4 * fa.f32_fwd_scratch(FLASH_BH, sq, skv, d)))
        calls.append(("flash_attention_bwd_fp32", (sq, skv, d), count,
                      4 * fa.f32_bwd_scratch(FLASH_BH, sq, skv, d)))
    name, shape, _, largest = max(calls, key=lambda c: c[3])
    by_kernel = {}
    for kernel, _, count, nbytes in calls:
        by_kernel[kernel] = by_kernel.get(kernel, 0) + count * nbytes
    return {"largest_bytes": largest, "largest": f"{name} {shape}",
            "total_bytes": sum(by_kernel.values()), "by_kernel": by_kernel}


def step_twin(step_fn, state, batch, label, per_step):
    """One graphed step of ``step_fn`` (``jit_train_step``: a capture, then
    its replay) against its eager twin from the same state and a generator
    of the same seed: loss and every carried tensor equal bit for bit;
    launches twice a step at the capture (warm-up + capture) and once
    eager.  Leaves the state as the graphed step left it."""
    import torch

    from diffusion_finetuning_tpu_torch.training.train_step import (carried_tensors,
                                                                    jit_train_step)

    tensors = carried_tensors(state)
    before = [t.detach().clone() for t in tensors]
    host_step = state["step"]
    gens = [torch.Generator(device=state["device_step"].device).manual_seed(SEED + 61)
            for _ in range(2)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _, metrics = jit_train_step(step_fn)(state, batch, gens[0])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graphed_counts = counts()
    graphed = (metrics["loss"].clone(), [t.detach().clone() for t in tensors])
    with torch.no_grad():
        torch._foreach_copy_(tensors, before)
    state["step"] = host_step
    reset_counts()
    _, metrics = step_fn(state, batch, gens[1])
    torch.cuda.synchronize()
    eager_counts = counts()
    eager = (metrics["loss"].clone(), [t.detach().clone() for t in tensors])
    differ = [i for i, (a, b) in enumerate(zip(eager[1], graphed[1])) if not torch.equal(a, b)]
    equal = torch.equal(eager[0], graphed[0]) and not differ
    if not equal:  # which tensors, by how much, and whether eager repeats itself
        worst = max((float((eager[1][i] - graphed[1][i]).abs().max()) for i in differ),
                    default=0.0)
        with torch.no_grad():
            torch._foreach_copy_(tensors, before)
        state["step"] = host_step
        gen = torch.Generator(device=state["device_step"].device).manual_seed(SEED + 61)
        _, metrics = step_fn(state, batch, gen)
        again = torch.equal(metrics["loss"], eager[0]) and all(
            torch.equal(a, b) for a, b in zip(tensors, eager[1]))
        log(f"{label}: loss graphed {float(graphed[0])!r} eager {float(eager[0])!r}; "
            f"{len(differ)} of {len(tensors)} tensors differ (first {differ[:5]}, max |diff| "
            f"{worst:.3e}); a second eager step equal to the first: {again}")
    with torch.no_grad():
        torch._foreach_copy_(tensors, graphed[1])
    state["step"] = host_step + 1
    want_graphed = captured(per_step, 1)
    log(f"{label}: graphed step (capture and replay {capture_s:.2f} s) equal to its eager twin "
        f"{equal} ({len(tensors)} tensors and the loss); launches {graphed_counts} graphed "
        f"(want {want_graphed}), {eager_counts} eager (want {per_step})")
    if graphed_counts != want_graphed or eager_counts != per_step:
        fail(f"{label} launched {graphed_counts} graphed and {eager_counts} eager")
    if not equal:
        fail(f"the graphed {label} step differs from its eager twin")
    return {"equal_to_eager": equal, "capture_s": capture_s, "launches": graphed_counts,
            "eager_launches": eager_counts}


def phase_dreambooth_fp32(model_dir, tmp):
    """``train_lora_dreambooth.main`` with no ``--mixed_precision``, i.e. the
    default fp32 trainer: 512^2, batch 2 with prior preservation (the class
    images the bf16 run made), the text LoRA, DB_STEPS steps at TRAINER_SPD a
    graph (the first dispatch captures, the second replays).  Its graphed ms
    a step, first dispatch s and peak memory, and exact launches of the
    fp32 kernels, none of the bf16 ones.  Then one graphed step of its step
    function against its eager twin, switches off (the trainer's path) and
    with the conv switch on (K5's fp32 kernel in the step)."""
    import torch

    from diffusion_finetuning_tpu_torch.models import layers
    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig
    from diffusion_finetuning_tpu_torch.training_scripts import train_lora_dreambooth as db

    args = dreambooth_args(model_dir, tmp, os.path.join(tmp, "dreambooth_fp32"))
    for flag in ("--mixed_precision", "--full_state_checkpoint_dir"):
        i = args.index(flag)
        del args[i:i + 2]
    made = {}
    real = db.FusedDispatcher

    class Recording(real):  # keeps the step function and the first batch
        def run(self, state, group, *a, **kw):
            made.setdefault("batch", group[0])
            made["step_fn"] = self._step_fn
            return super().run(state, group, *a, **kw)

    per_step = fp32_step_launches()
    db.FusedDispatcher = Recording
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state = db.main(db.parse_args(args))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
    finally:
        db.FusedDispatcher = real
    want = captured(per_step, TRAINER_SPD)
    row = {"wall_s": wall, "step_launches": per_step,
           "train": check_phase_log(state["log"]["dispatch"], "DreamBooth fp32", want),
           "split_scratch": fp32_step_scratch()}
    peak = row["train"]["peak_bytes"]
    sc = row["split_scratch"]
    log(f"DreamBooth fp32: peak memory {'n/a' if peak is None else f'{peak / 2**30:.2f}'} GiB "
        f"beside the fp32 kernels' split scratch of one step: largest call "
        f"{sc['largest_bytes'] / 2**20:.1f} MiB ({sc['largest']}), all calls "
        f"{sc['total_bytes'] / 2**30:.2f} GiB (" + ", ".join(
            f"{name} {n / 2**30:.2f}" for name, n in sc["by_kernel"].items())
        + "), each call's freed when it returns")
    if got != want:
        fail(f"the fp32 DreamBooth run launched {got}, want {want}")
    if state["step"] != DB_STEPS:
        fail(f"the fp32 DreamBooth run reached step {state['step']}")
    state.pop("log")
    # cuDNN picks fp32 convolution algorithms whose sums vary from call to
    # call unless asked not to (two eager steps from one state differ by an
    # ulp, while the port's kernels repeat bit for bit): the twins run with
    # cudnn.deterministic, graphed and eager alike
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    k5 = sum(unet_conv3x3_calls(UNetConfig.sd15(), 2, IMAGE // 8, itemsize=4).values())
    try:
        row["twin"] = step_twin(made["step_fn"], state, made["batch"], "DreamBooth fp32",
                                per_step)
        layers.CONV_KERNEL = True
        row["twin_conv_switch"] = step_twin(
            made["step_fn"], state, made["batch"], "DreamBooth fp32, conv switch on",
            add_counts(per_step, {"conv3x3_fp32": k5}))
    finally:
        layers.CONV_KERNEL = False
        torch.backends.cudnn.deterministic = deterministic
    log(f"DreamBooth fp32: {wall:.1f} s")
    return add_counts(got, row["twin"]["launches"], row["twin_conv_switch"]["launches"]), row


def phase_w_ti(model_dir, tmp):
    """``train_lora_w_ti.main`` at 512^2 in bf16: 8 steps at 4 a graph
    (the LoRA unfrozen at step 2, inside the first graph), saves at 4 and 8;
    its .pt, .ti.pt and safetensors files read back."""
    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.io import safetensors_io
    from diffusion_finetuning_tpu_torch.training_scripts import train_lora_w_ti as wti

    _, lora_step = trainer_step_launches()
    out = os.path.join(tmp, "w_ti")
    args = wti.parse_args([
        "--pretrained_model_name_or_path", model_dir,
        "--instance_data_dir", os.path.join(tmp, "instance"), "--placeholder_token", "<krk>",
        "--initializer_token", "person", "--output_dir", out, "--resolution", str(IMAGE),
        "--train_batch_size", "1", "--max_train_steps", str(WTI_STEPS),
        "--save_steps", str(TRAINER_SAVE), "--steps_per_dispatch", str(TRAINER_SPD),
        "--unfreeze_lora_step", "2", "--lr_warmup_steps", "0", "--lora_rank", str(LORA_RANK),
        "--mixed_precision", "bf16", "--seed", str(SEED)])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state = wti.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    row = {"wall_s": wall, "train": check_phase_log(state["log"]["dispatch"], "w_ti",
                                                    captured(lora_step, TRAINER_SPD))}
    if got != captured(lora_step, TRAINER_SPD):
        fail(f"w_ti launched {got}")
    files = sorted(os.listdir(out))
    want = {"lora_weight.pt", "lora_weight.text_encoder.pt", "lora_weight.ti.pt",
            "lora_weight.safetensors"}
    periodic = [f for f in files if f.startswith("lora_weight_e")
                and f.endswith((f"_s{WTI_STEPS}.pt", f"_s{WTI_STEPS}.text_encoder.pt",
                                f"_s{WTI_STEPS}.ti.pt"))]
    if not want <= set(files) or len(periodic) != 3:
        fail(f"w_ti wrote {files}, want {sorted(want)} and the step-{WTI_STEPS} saves")
    ti = torch.load(os.path.join(out, "lora_weight.ti.pt"), weights_only=True)
    tensors, meta = safetensors_io.read_safetensors(os.path.join(out, "lora_weight.safetensors"))
    embeds = lora_lib.parse_safeloras_embeds(tensors, meta)
    if not (set(ti) == {"<krk>"} == set(embeds) and torch.equal(ti["<krk>"], embeds["<krk>"])
            and set(lora_lib.parse_safeloras(tensors, meta)) == {"unet", "text_encoder"}):
        fail("w_ti's .ti.pt and safetensors do not read back")
    for name in ("lora_weight.pt", "lora_weight.text_encoder.pt"):
        flat = torch.load(os.path.join(out, name), weights_only=True)
        if not flat or not all(t.dtype == torch.float16 and torch.isfinite(t).all()
                               for t in flat):
            fail(f"w_ti's {name} is not a finite fp16 flat list")
    log(f"w_ti: {wall:.1f} s; files {files} read back")
    return got, row


def phase_trainers(model_dir, tmp):
    """Phase 9: the trainers on the card at SD1.5 width and 512^2, from
    phase 8's bf16 model directory."""
    import gc

    import torch

    train_images(os.path.join(tmp, "instance"), SEED + 90, TRAIN_IMAGES)
    from diffusion_finetuning_tpu_torch.data import native_loader

    log("phase 9 images decode through " + (
        "the native loader" if native_loader.available()
        else f"PIL (the native loader did not build: {native_loader.unavailable_reason})"))
    launches, rows = {}, {}
    t0 = time.time()
    pipe, launches["pti"], rows["pti"] = phase_pti(model_dir, tmp)
    launches["pti_serving"], rows["pti_serving"] = phase_pti_serving(pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9 PTI: {time.time() - t0:.1f} s")
    t0 = time.time()
    launches["dreambooth"], rows["dreambooth"] = phase_dreambooth(model_dir, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9 DreamBooth: {time.time() - t0:.1f} s")
    t0 = time.time()
    launches["dreambooth_fp32"], rows["dreambooth_fp32"] = phase_dreambooth_fp32(model_dir, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9 DreamBooth fp32: {time.time() - t0:.1f} s")
    t0 = time.time()
    launches["w_ti"], rows["w_ti"] = phase_w_ti(model_dir, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9 w_ti: {time.time() - t0:.1f} s")
    return launches, rows



# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

SAMPLER_STEPS = 20          # strength 0.75: 15 UNet steps (PNDM's grid of 21: 16)
SAMPLER_STRENGTH = 0.75
IMG2IMG_SAMPLERS = ("dpm", "pndm", "euler", "euler_a", "lms", "lms:karras")
SAMPLER_REPLAYS = 2
SAMPLER_REF = ("lms", "euler_a")  # a stateful and an ancestral sampler against the CPU
SAMPLER_REF_STEPS = 4       # strength 0.75: t_start 1, 3 UNet steps
MERGE_ALPHA = 0.8
DISTILL_RANK = 4
# ||U Vh - alpha up down||_F / ||alpha up down||_F of each distilled pair
# before the clamp: the delta is read back as (W + alpha up down) - W in fp32,
# off by an fp32 rounding of |W| (|W| / |delta| about 10 here: ~1e-6), and
# the SVD of a rank-4 matrix adds fp32 error of the same order; 100x margin.
# The clamp at the signed 0.99 quantile then cuts the largest entries (and,
# by the sign the solver chose, can cut more): its error is reported only.
DISTILL_REL_FRO = 1e-4
VIS_STEPS = 10


def img2img_unet_steps(scheduler, steps, strength):
    """UNet calls of an img2img request, from the code: the sampler's grid
    from its txt2img scheduler, started at ``img2img_start``."""
    from diffusion_finetuning_tpu_torch.models.schedulers import (SchedulerConfig,
                                                                  txt2img_scheduler)
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import img2img_start

    grid = len(txt2img_scheduler(scheduler, SchedulerConfig()).timesteps(steps))
    return grid - img2img_start(grid, strength)


def dir_bytes(path):
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def phase_img2img_samplers(pipe):
    """img2img at 512^2, strength 0.75, 20 steps, batch 1, adapter B dynamic
    (UNet and text LoRA through K2), with each sampler of IMG2IMG_SAMPLERS:
    a first graphed request (warm-up, capture, replay), SAMPLER_REPLAYS
    replays, then the last one's eager twin, which must equal it bit for
    bit.  Launches, with the counters set to 0 just before the graphed
    requests and read just after: twice a call's (warm-up and capture), none
    at the replays; the eager request's: one call's."""
    import numpy as np
    import torch

    pipe.cuda_graphs = True
    image = init_image(IMAGE)
    prompt = f"a portrait of {TOKEN_B}"
    rows, total = [], want_counts()
    for sch in IMG2IMG_SAMPLERS:
        n = img2img_unet_steps(sch, SAMPLER_STEPS, SAMPLER_STRENGTH)
        per_call = want_counts(flash_attention_fwd=FLASH_PER_STEP * n,
                               lora_dense=LORA_PER_STEP * n + TEXT_LORA_PER_ENCODE,
                               group_norm=pipe_norms(pipe, n, encode=True))
        kw = dict(strength=SAMPLER_STRENGTH, num_inference_steps=SAMPLER_STEPS,
                  guidance_scale=GUIDANCE, scheduler=sch, output_type="device")
        graphs_before = 0 if pipe._graphs is None else len(pipe._graphs.graphs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        pipe.img2img(prompt, image, seed=1, **kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        walls = []
        for i in range(SAMPLER_REPLAYS):
            t0 = time.perf_counter()
            out = pipe.img2img(prompt, image, seed=2 + i, **kw)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        pipe.cuda_graphs = False
        reset_counts()
        t0 = time.perf_counter()
        eager = pipe.img2img(prompt, image, seed=1 + SAMPLER_REPLAYS, **kw)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        eager_counts = counts()
        pipe.cuda_graphs = True
        want = {k: 2 * v for k, v in per_call.items()}
        captured_now = len(pipe._graphs.graphs) - graphs_before
        equal = torch.equal(out, eager)
        row = dict(scheduler=sch, unet_steps=n, first_call_s=first_s,
                   graphed_ms=sorted(walls)[len(walls) // 2], graphed_ms_all=walls,
                   eager_ms=eager_ms, peak_bytes=peak, launches=got, eager_launches=eager_counts,
                   graphs_captured=captured_now, equal_to_eager=equal)
        rows.append(row)
        log(f"img2img {sch}: {n} UNet steps; first call (warm-up + capture + replay) "
            f"{first_s:.2f} s, graphed {row['graphed_ms']:.1f} ms (of {[round(w, 1) for w in walls]}), "
            f"eager {eager_ms:.1f} ms; peak {peak / 2**30:.2f} GiB; launches {got} (want {want}), "
            f"eager {eager_counts}; equal to eager {equal}")
        if got != want or eager_counts != per_call:
            fail(f"img2img {sch} launched {got} graphed and {eager_counts} eager, want {want} "
                 f"and {per_call}")
        if captured_now != 1:
            fail(f"img2img {sch} captured {captured_now} graphs, want 1")
        if not equal:
            fail(f"the graphed img2img {sch} request differs from the eager one")
        arr = out.cpu().numpy()
        if arr.shape != (1, IMAGE, IMAGE, 3) or not arr.std() > 0:
            fail(f"img2img {sch} gave {arr.shape} with std {arr.std()}")
        for k, v in got.items():
            total[k] += v
    pipe.release_graphs()
    return total, rows


def phase_sampler_reference(pipe, cpu_pipe):
    """A stateful and an ancestral sampler (SAMPLER_REF) at 128^2, strength
    0.75, 4 steps, adapter B dynamic: the card in bf16 against the CPU in
    fp32 with the same draws (Euler-ancestral's per-step noise among them)."""
    import numpy as np

    side = REF_IMAGE // pipe.vae_scale_factor
    prompts = [f"a portrait of {TOKEN_B}", "photo of sks person"]
    pipe.cuda_graphs = False
    rows = {}
    for sch in SAMPLER_REF:
        n = img2img_unet_steps(sch, SAMPLER_REF_STEPS, SAMPLER_STRENGTH)
        rng = np.random.default_rng(SEED + 100)
        draws = {"sample": rng.standard_normal((1, side, side, 4)).astype(np.float32),
                 "noise": rng.standard_normal((2, side, side, 4)).astype(np.float32),
                 "ancestral": rng.standard_normal((n, 2, side, side, 4)).astype(np.float32)}
        kw = dict(strength=SAMPLER_STRENGTH, num_inference_steps=SAMPLER_REF_STEPS,
                  guidance_scale=GUIDANCE, scheduler=sch, draws=draws, output_type="np")
        got = pipe.img2img(prompts, init_image(REF_IMAGE), **kw)
        t0 = time.time()
        want = cpu_pipe.img2img(prompts, init_image(REF_IMAGE), **kw)
        diff = np.abs(got - want)
        rows[sch] = {"mean_abs_diff": float(diff.mean()), "max_abs_diff": float(diff.max())}
        log(f"img2img {sch} 128^2 x{SAMPLER_REF_STEPS} steps ({n} UNet), card bf16 vs CPU fp32: "
            f"mean |diff| {diff.mean():.3e} (limit {PIPE_MEAN_ABS}), max {diff.max():.3e}, "
            f"image std {got.std():.3e}; CPU reference {time.time() - t0:.1f} s")
        if got.shape != (2, REF_IMAGE, REF_IMAGE, 3) or not diff.mean() <= PIPE_MEAN_ABS:
            fail(f"img2img {sch} on the card disagrees with the CPU fp32 reference")
        if not got.std() > 1e-3:
            fail(f"img2img {sch} images are constant")
    pipe.cuda_graphs = True
    return rows


def pt_pair_of_safetensors(path, out):
    """Adapter A's UNet and text LoRA as the ``.pt`` pair ``lpl`` reads
    (fp16, as the reference's ``.pt`` saves)."""
    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.io import safetensors_io

    tensors, meta = safetensors_io.read_safetensors(path)
    loras = safetensors_io.parse_safeloras(tensors, meta)
    for name, p in (("unet", out), ("text_encoder", lora_lib._text_lora_path(out))):
        torch.save([t.half().clone() for t in loras[name][0]], p)


def phase_lora_add(model_dir, paths, tmp):
    """``lora_add`` at SD1.5 width on the card: ``upl`` of adapter B (UNet
    and text, alpha MERGE_ALPHA) into phase 8's directory, written fp32,
    each merged weight equal to ``weight_apply_lora`` on the card over the
    directory's weights;
    ``upl-ckpt-v2`` to an fp16 ``.ckpt`` that ``torch.load(weights_only=True)``
    reads, its UNet the fp16 of the ``upl`` one; ``lpl`` of A's and B's
    ``.pt`` pairs."""
    import torch

    from diffusion_finetuning_tpu_torch import cli_lora_add
    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.models import hf_loading
    from diffusion_finetuning_tpu_torch.models.clip_text import (CLIPTextModel,
                                                                 text_encoder_lora_targets)
    from diffusion_finetuning_tpu_torch.models.unet import UNet2DConditionModel, unet_lora_targets
    from diffusion_finetuning_tpu_torch.to_ckpt_v2 import convert_unet_state_dict

    rows = {}
    upl_dir = os.path.join(tmp, "upl")
    t0 = time.perf_counter()
    cli_lora_add.add(model_dir, paths["B"], upl_dir, alpha=MERGE_ALPHA, mode="upl",
                     with_text_lora=True)
    torch.cuda.synchronize()
    rows["upl"] = {"s": time.perf_counter() - t0, "bytes": dir_bytes(upl_dir)}
    changed = {}
    for sub, cls, targets, replace, path in (
            ("unet", UNet2DConditionModel, unet_lora_targets(hf_loading.unet_config_from_hf(
                hf_loading.read_json(os.path.join(model_dir, "unet", "config.json")))),
             lora_lib.DEFAULT_TARGET_REPLACE, paths["B"]),
            ("text_encoder", CLIPTextModel, text_encoder_lora_targets(
                hf_loading.clip_config_from_hf(hf_loading.read_json(
                    os.path.join(model_dir, "text_encoder", "config.json")))),
             lora_lib.TEXT_ENCODER_DEFAULT_TARGET_REPLACE, lora_lib._text_lora_path(paths["B"]))):
        base = {k: v.to("cuda", torch.float32) for k, v in
                hf_loading.load_model_dir_state_dict(os.path.join(model_dir, sub)).items()}
        want = lora_lib.weight_apply_lora(base, path, lora_lib.filter_targets(targets, replace),
                                          alpha=MERGE_ALPHA, prefix=cls.lora_prefix)
        got = hf_loading.load_model_dir_state_dict(os.path.join(upl_dir, sub))
        bad = [k for k in want if got[k].dtype != torch.float32
               or not torch.equal(got[k].cuda(), want[k])]
        if bad or got.keys() != want.keys():
            fail(f"upl's {sub} differs from weight_apply_lora at {bad[:3]}")
        changed[sub] = sum(not torch.equal(want[k], v) for k, v in base.items())
        if sub == "unet":
            unet_fp16 = {k: v.half() for k, v in convert_unet_state_dict(got).items()}
        del base, want, got
    want_changed = {"unet": LORA_PER_STEP, "text_encoder": TEXT_LORA_PER_ENCODE}
    if changed != want_changed:
        fail(f"upl changed {changed} weights, want {want_changed}")
    gc.collect()
    torch.cuda.empty_cache()

    ckpt = os.path.join(tmp, "merged.ckpt")
    t0 = time.perf_counter()
    cli_lora_add.add(model_dir, paths["B"], ckpt, alpha=MERGE_ALPHA, mode="upl-ckpt-v2",
                     with_text_lora=True)
    torch.cuda.synchronize()
    ckpt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    read_s = time.perf_counter() - t0
    floats = [v for v in sd.values() if v.is_floating_point()]
    bad = [k for k, v in unet_fp16.items() if not torch.equal(sd["model.diffusion_model." + k], v)]
    rows["upl_ckpt_v2"] = {"s": ckpt_s, "bytes": os.path.getsize(ckpt), "keys": len(sd),
                           "read_s": read_s}
    if os.path.exists(ckpt + ".tmp") or not floats or any(v.dtype != torch.float16
                                                          for v in floats):
        fail("upl-ckpt-v2 left its temporary directory or wrote non-fp16 floats")
    if bad:
        fail(f"the .ckpt's UNet is not the fp16 of upl's at {bad[:3]}")
    del sd

    a_pt, out = os.path.join(tmp, "adapter_a.pt"), os.path.join(tmp, "lpl.pt")
    pt_pair_of_safetensors(paths["A"], a_pt)
    t0 = time.perf_counter()
    cli_lora_add.add(a_pt, paths["B"], out, alpha=0.5, mode="lpl", with_text_lora=True)
    lpl_s = time.perf_counter() - t0
    n = 0
    files = [(a_pt, paths["B"], out)]
    files.append(tuple(lora_lib._text_lora_path(f) for f in files[0]))
    for pa, pb, po in files:
        la, lb, lo = (torch.load(x, weights_only=True) for x in (pa, pb, po))
        if len(lo) != len(la) or not all(
                o.dtype == torch.float16 and torch.equal(o, (0.5 * a.float() + 0.5 * b.float()).half())
                for o, a, b in zip(lo, la, lb)):
            fail(f"lpl's {po} is not the fp32 interpolation of {pa} and {pb}")
        n += len(lo)
    rows["lpl"] = {"s": lpl_s, "bytes": dir_bytes(out) + dir_bytes(lora_lib._text_lora_path(out)),
                   "tensors": n}
    log(f"lora_add: upl {rows['upl']['s']:.1f} s ({rows['upl']['bytes'] / 2**30:.3f} GiB fp32; "
        f"{changed['unet']} UNet and {changed['text_encoder']} text weights merged, each equal "
        f"to weight_apply_lora); upl-ckpt-v2 {ckpt_s:.1f} s ({rows['upl_ckpt_v2']['bytes'] / 2**30:.3f} "
        f"GiB fp16, {rows['upl_ckpt_v2']['keys']} keys, read back in "
        f"{read_s:.1f} s, UNet = fp16 of upl's); lpl {lpl_s:.2f} s ({n} tensors, "
        f"{rows['lpl']['bytes']} bytes)")
    return upl_dir, rows


def phase_distill(model_dir, upl_dir, paths, tmp):
    """``lora_distill`` at rank 4 between phase 8's directory and the fp32
    ``upl`` one, its SVDs on the card.  Each pair before the clamp must give
    MERGE_ALPHA x adapter B's up down within DISTILL_REL_FRO (relative
    Frobenius); the file holds the clamped pairs exactly."""
    import torch

    from diffusion_finetuning_tpu_torch import cli_svd
    from diffusion_finetuning_tpu_torch import lora as lora_lib

    seen = []
    real = cli_svd.clamp_pair

    def spy(U, Vh, q):
        out = real(U, Vh, q)
        seen.append((U, Vh) + out)
        return out

    save = os.path.join(tmp, "distilled.pt")
    cli_svd.clamp_pair = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_svd.svd_distill(upl_dir, model_dir, rank=DISTILL_RANK, save_path=save)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cli_svd.clamp_pair = real
    files = [torch.load(p, weights_only=True) for p in (save, lora_lib._text_lora_path(save))]
    wants = [torch.load(p, weights_only=True) for p in (paths["B"],
                                                        lora_lib._text_lora_path(paths["B"]))]
    saved = files[0] + files[1]
    want_flat = wants[0] + wants[1]
    if len(seen) != len(want_flat) // 2 or len(saved) != len(want_flat):
        fail(f"lora_distill made {len(seen)} pairs, want {len(want_flat) // 2}")
    rel, rel_clamped = [], []
    for i, (U, Vh, Uc, Vc) in enumerate(seen):
        if not (U.is_cuda and U.shape[1] == DISTILL_RANK):
            fail("lora_distill's SVDs did not run on the card at the rank asked for")
        want = MERGE_ALPHA * (want_flat[2 * i].cuda().float() @ want_flat[2 * i + 1].cuda().float())
        rel.append(float((U @ Vh - want).norm() / want.norm()))
        rel_clamped.append(float((Uc @ Vc - want).norm() / want.norm()))
        if not (torch.equal(saved[2 * i], Uc.cpu()) and torch.equal(saved[2 * i + 1], Vc.cpu())):
            fail(f"lora_distill's file differs from its clamped pair {i}")
    row = {"s": wall, "pairs": len(seen), "max_rel_fro": max(rel),
           "max_rel_fro_clamped": max(rel_clamped),
           "median_rel_fro_clamped": sorted(rel_clamped)[len(rel_clamped) // 2],
           "bytes": dir_bytes(save) + dir_bytes(lora_lib._text_lora_path(save))}
    log(f"lora_distill: {len(seen)} rank-{DISTILL_RANK} pairs on the card in {wall:.1f} s; "
        f"before the clamp max relative Frobenius error {max(rel):.3e} (limit {DISTILL_REL_FRO}); "
        f"after the 0.99-quantile clamp max {max(rel_clamped):.3e}, median "
        f"{row['median_rel_fro_clamped']:.3e}; files {row['bytes']} bytes")
    if not max(rel) <= DISTILL_REL_FRO:
        fail(f"lora_distill's pairs miss adapter B's delta by {max(rel):.3e}")
    return row


def phase_scripts(model_dir, paths, tmp):
    """``run_img2img`` (adapter A merged, "dpm", 512^2, 20 steps) and
    ``visualize_training_progress`` (adapters A and B merged, 10 DDIM steps
    each, fp32 as in JAX: K1's fp32 kernel, no bf16 K1) through their
    ``run`` functions.  Launches, counters set to 0 just before each: twice
    a captured graph's (warm-up and capture), none at replays; the swap from
    A to B captures nothing."""
    import numpy as np
    import torch
    from PIL import Image

    from diffusion_finetuning_tpu_torch.pipelines import pipeline as pipeline_mod
    from diffusion_finetuning_tpu_torch.scripts import run_img2img, visualize_training_progress

    rows, launches = {}, {}
    init = os.path.join(tmp, "init.png")
    Image.fromarray(init_image(IMAGE)).save(init)
    out = os.path.join(tmp, "img2img.png")
    n = img2img_unet_steps("dpm", SAMPLER_STEPS, SAMPLER_STRENGTH)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    run_img2img.run(model_dir, paths["A"], init, out, prompt=f"a photo of {TOKEN_A}",
                    strength=SAMPLER_STRENGTH, steps=SAMPLER_STEPS, scheduler="dpm", seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["run_img2img"] = got = counts()
    want = want_counts(flash_attention_fwd=2 * FLASH_PER_STEP * n,
                       group_norm=2 * request_norms(*sd15_configs()[:2], n, encode=True))
    img = np.asarray(Image.open(out))
    rows["run_img2img"] = {"s": wall, "unet_steps": n, "launches": got}
    log(f"run_img2img: {wall:.2f} s (load, patch A, capture, one request); launches {got} "
        f"(want {want})")
    if got != want:
        fail(f"run_img2img launched {got}, want {want}")
    if img.shape != (IMAGE, IMAGE, 3) or not img.std() > 0:
        fail(f"run_img2img wrote {img.shape} with std {img.std()}")
    gc.collect()
    torch.cuda.empty_cache()

    made = []
    real = pipeline_mod.StableDiffusionPipeline.from_pretrained

    def keep(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    grid = os.path.join(tmp, "progress.png")
    pipeline_mod.StableDiffusionPipeline.from_pretrained = keep
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        visualize_training_progress.run(model_dir, [paths["A"], paths["B"]], grid,
                                        prompt="a photo of sks person", steps=VIS_STEPS,
                                        seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline_mod.StableDiffusionPipeline.from_pretrained = real
    launches["visualize_progress"] = got = counts()
    graphs = len(made[0]._graphs.graphs)
    want = want_counts(flash_attention_fwd_fp32=2 * FLASH_PER_STEP * VIS_STEPS * graphs,
                       group_norm=2 * request_norms(*sd15_configs()[:2], VIS_STEPS) * graphs)
    arr = np.asarray(Image.open(grid))
    rows["visualize_progress"] = {"s": wall, "graphs": graphs, "launches": got}
    log(f"visualize_training_progress: {wall:.2f} s for 2 checkpoints ({graphs} graph "
        f"captured); launches {got} (want {want})")
    if got != want or graphs != 1:
        fail(f"visualize_training_progress launched {got} over {graphs} graphs, want {want} "
             "over 1")
    if arr.shape != (IMAGE, 2 * IMAGE, 3) or np.array_equal(arr[:, :IMAGE], arr[:, IMAGE:]):
        fail("visualize_training_progress's grid is misshapen or its two images equal")
    del made
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rows


def phase_rest_of_card(model_dir, tmp):
    """Phase 10: img2img with every sampler, the LoRA tools and the notebook
    scripts on the card, from phase 8's directory and adapters."""
    import torch

    from diffusion_finetuning_tpu_torch.pipelines.pipeline import (StableDiffusionPipeline,
                                                                   patch_pipe)

    paths = {"A": os.path.join(tmp, "adapter_a.safetensors"),
             "B": os.path.join(tmp, "adapter_b.pt")}
    rows, launches = {}, {}
    t0 = time.time()
    pipe = StableDiffusionPipeline.from_pretrained(model_dir, dtype=torch.bfloat16, device="cuda")
    patch_pipe(pipe, paths["B"], patch_text=True, patch_ti=True)
    pipe.materialize_lora = False
    launches["img2img_samplers"], rows["img2img_samplers"] = phase_img2img_samplers(pipe)
    log(f"phase 10 samplers: {time.time() - t0:.1f} s")
    t0 = time.time()
    cpu_pipe = StableDiffusionPipeline.from_pretrained(model_dir, device="cpu")
    patch_pipe(cpu_pipe, paths["B"], patch_text=True, patch_ti=True)
    cpu_pipe.materialize_lora = False
    rows["sampler_reference"] = phase_sampler_reference(pipe, cpu_pipe)
    del pipe, cpu_pipe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 10 sampler reference: {time.time() - t0:.1f} s")
    t0 = time.time()
    upl_dir, rows["lora_add"] = phase_lora_add(model_dir, paths, tmp)
    log(f"phase 10 lora_add: {time.time() - t0:.1f} s")
    t0 = time.time()
    rows["lora_distill"] = phase_distill(model_dir, upl_dir, paths, tmp)
    shutil.rmtree(upl_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 10 lora_distill: {time.time() - t0:.1f} s")
    t0 = time.time()
    script_launches, rows["scripts"] = phase_scripts(model_dir, paths, tmp)
    launches.update(script_launches)
    log(f"phase 10 scripts: {time.time() - t0:.1f} s")
    return launches, rows

# ---------------------------------------------------------------------------
# phase 11: the multi-device slice (parallel/) on one card
# ---------------------------------------------------------------------------

PAR_RANKS = 2
# one data-parallel fp32 DreamBooth step against the one-process step on the
# same batch and draws.  The LoRA gradient (summed over the ranks) within
# 1e-4 relative L2, the CPU tests' bound (the same fp32 sums in another
# order: each rank's K1/K2/K3 sum one row where one process sums two, in
# another tiling); the loss within 1e-5.  The LoRA update (parameters after
# minus before) within 1e-2 relative L2: the first AdamW step is about
# lr * sign(g), so a gradient element whose sum cancels to near zero takes
# either sign, its update +-lr, in one order or the other (a few such
# elements out of millions); per-element bounds do not hold for those
PAR_GRAD_REL_L2 = 1e-4
PAR_UPDATE_REL_L2 = 1e-2
PAR_LOSS_RTOL = 1e-5
# bf16 eps of the tp=2 CFG UNet step against the unsplit step: two bf16
# runs rounding at different points (each row layer's halves round to bf16
# before their fp32 sum, where the unsplit K2 rounds once; the LoRA's h
# rounds per half, parallel/tp.py), each within UNET_REL_L2 of an fp32 run
PAR_TP_REL_L2 = UNET_REL_L2
PAR_TIMEOUT_S = 600


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lora_flat(params, grads=False):
    """The trainable tensors (or their gradients) end to end, on the CPU."""
    import torch

    from diffusion_finetuning_tpu_torch.training.optim import trainable_tensors

    return torch.cat([(t.grad if grads else t).detach().float().reshape(-1).cpu()
                      for t in trainable_tensors(params)])


def parallel_rank(rank, work):
    """One rank of phase 11 (a child process; gloo, both ranks on cuda:0):
    (a) the fp32 DreamBooth trainer, one step, data = 2, one example a rank;
    (b) an eager bf16 CFG UNet step with tp = 2 (rank 0 also runs it
    unsplit first).  Writes ``rank{R}.pt`` into ``work``."""
    import torch

    from diffusion_finetuning_tpu_torch.lora import attached
    from diffusion_finetuning_tpu_torch.parallel import mesh as mesh_lib
    from diffusion_finetuning_tpu_torch.parallel import tp as tp_lib
    from diffusion_finetuning_tpu_torch.pipelines.pipeline import StableDiffusionPipeline
    from diffusion_finetuning_tpu_torch.training_scripts import train_lora_dreambooth as db

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    dev = spec.get("device", "cuda:0")  # the CPU in a rehearsal at a small size
    mesh_lib.initialize_distributed(f"file://{work}/rendezvous", PAR_RANKS, rank,
                                    backend="gloo", device=dev)
    out = {}
    t0 = time.perf_counter()
    reset_counts()
    state = db.main(db.parse_args(spec["db_args"] + ["--output_dir",
                                                     os.path.join(work, f"db{rank}")]),
                    device=dev)
    torch.cuda.synchronize()
    out["dp_counts"] = counts()
    out["dp_params"] = _lora_flat(state["params"])
    out["dp_grads"] = _lora_flat(state["params"], grads=True)
    out["dp_losses"] = [float(x) for x in state["log"]["dispatch"]["losses"]]
    out["dp_s"] = time.perf_counter() - t0
    del state
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.from_pretrained(spec["model_dir"], dtype=torch.bfloat16,
                                                   device=dev)
    x, t, ctx = (v.to(dev) for v in spec["unet_inputs"])
    lora = tree_to(spec["lora"], dev)

    def unet_step():
        with torch.no_grad(), attached(pipe.unet, lora):
            eps = pipe.unet(x, t, ctx)
        torch.cuda.synchronize()
        return eps

    if rank == 0:
        out["tp_ref"] = unet_step().float().cpu()
    mesh = mesh_lib.make_mesh(PAR_RANKS, ("data", "tp"), (1, PAR_RANKS), device=dev)
    tp_lib.shard_module(pipe.unet, mesh)
    blk = "down_blocks.0.attentions.0.transformer_blocks.0"
    out["tp_shapes"] = {
        "to_q": tuple(pipe.unet.get_submodule(blk + ".attn1.to_q").weight.shape),
        "to_out": tuple(pipe.unet.get_submodule(blk + ".attn1.to_out.0").weight.shape),
        "geglu": tuple(pipe.unet.get_submodule(blk + ".ff.net.0.proj").weight.shape),
        "heads": pipe.unet.get_submodule(blk + ".attn1").heads}
    unet_step()  # warm-up
    reset_counts()
    eps = unet_step()
    out["tp_counts"] = counts()
    out["tp_eps"] = eps.float().cpu()
    out["tp_ms"] = wall_ms(unet_step, 3)
    out["tp_s"] = time.perf_counter() - t0
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    mesh_lib.barrier("phase 11")
    torch.distributed.destroy_process_group()


def _run_ranks(work):
    """The two ranks of phase 11 as child processes of this script."""
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(PAR_RANKS)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                               "--parallel-rank", str(r), "--parallel-dir", work],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=HERE)
             for r in range(PAR_RANKS)]
    try:
        rcs = [p.wait(timeout=PAR_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        for r in range(PAR_RANKS):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                log(f"--- rank {r} (exit {rcs[r]}) ---\n" + f.read()[-6000:])
        fail(f"phase 11 ranks exited {rcs}")
    import torch

    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(PAR_RANKS)]


def phase_parallel(model_dir, tmp):
    """Phase 11: (a) the fp32 DreamBooth trainer with data = 2 over two
    ranks sharing the card (gloo), one example a rank (prior preservation:
    rank 0 the instance row, rank 1 the class row), against the same
    trainer in one process at batch 2, the same draws; (b) an eager bf16
    CFG UNet step at 64x64 latents with tp = 2, against the unsplit step
    (rank 0's), K1 and K2 launched on both ranks at the shard shapes; (c) one graphed
    step through a one-rank NCCL mesh passed to ``FusedDispatcher``, equal
    bit for bit to the mesh-free graphed step."""
    import torch
    import torch.distributed as dist

    from diffusion_finetuning_tpu_torch.parallel import mesh as mesh_lib
    from diffusion_finetuning_tpu_torch.training.train_step import (FusedDispatcher,
                                                                    carried_tensors)
    from diffusion_finetuning_tpu_torch.training_scripts import train_lora_dreambooth as db

    work = tempfile.mkdtemp(prefix="parallel_", dir=tmp)
    args = dreambooth_args(model_dir, tmp, "unused")
    for flag in ("--mixed_precision", "--full_state_checkpoint_dir", "--output_dir"):
        i = args.index(flag)
        del args[i:i + 2]
    for flag, value in (("--max_train_steps", "1"), ("--steps_per_dispatch", "1")):
        args[args.index(flag) + 1] = value
    ucfg = sd15_configs()[0]
    x, t, ctx = unet_step_inputs(types.SimpleNamespace(unet_config=ucfg, vae_scale_factor=8))
    torch.save({"db_args": args, "model_dir": model_dir, "unet_inputs": (x, t, ctx),
                "lora": random_lora(ucfg)}, os.path.join(work, "spec.pt"))
    t0 = time.perf_counter()
    ranks = _run_ranks(work)
    ranks_s = time.perf_counter() - t0

    # (a) against one process
    made = {}
    real = db.FusedDispatcher

    class Recording(real):  # keeps the step function, the batch, the LoRA before
        def run(self, state, group, *a, **kw):
            made.setdefault("batch", group[0])
            made.setdefault("before", _lora_flat(state["params"]))
            made["step_fn"] = self._step_fn
            return super().run(state, group, *a, **kw)

    db.FusedDispatcher = Recording
    try:
        t0 = time.perf_counter()
        reset_counts()
        state = db.main(db.parse_args(args + ["--output_dir", os.path.join(work, "db_one")]))
        torch.cuda.synchronize()
        one_counts, one_s = counts(), time.perf_counter() - t0
    finally:
        db.FusedDispatcher = real
    one = _lora_flat(state["params"])
    one_grad = _lora_flat(state["params"], grads=True)
    one_losses = [float(x) for x in state["log"]["dispatch"]["losses"]]
    update = one - made["before"]
    per_step = fp32_step_launches()
    lr = 1e-4  # dreambooth_args' --learning_rate
    dp = {"one_process_s": one_s, "ranks_s": ranks_s}
    errs = []
    for r, res in enumerate(ranks):
        grad_rel = float((res["dp_grads"] - one_grad).norm() / one_grad.norm())
        upd_rel = float((res["dp_params"] - made["before"] - update).norm() / update.norm())
        diff = (res["dp_params"] - one).abs()
        loss_rel = abs(res["dp_losses"][0] - one_losses[0]) / abs(one_losses[0])
        row = {"loss": res["dp_losses"][0], "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
               "update_rel_l2": upd_rel, "param_max_abs_diff": float(diff.max()),
               "params_off_by_2pct_lr": int((diff > 2e-2 * lr).sum()),
               "params": diff.numel(), "launches": res["dp_counts"], "trainer_s": res["dp_s"]}
        log(f"phase 11 (a) rank {r}: loss {row['loss']!r} vs one process {one_losses[0]!r} "
            f"(rel {loss_rel:.2e}, gate {PAR_LOSS_RTOL}); LoRA gradient rel L2 {grad_rel:.2e} "
            f"(gate {PAR_GRAD_REL_L2}); update rel L2 {upd_rel:.2e} (gate {PAR_UPDATE_REL_L2}); "
            f"parameters max |diff| {row['param_max_abs_diff']:.3e}, "
            f"{row['params_off_by_2pct_lr']} of {row['params']} off by more than 2% of the LR; "
            f"launches {res['dp_counts']} (want {per_step}); trainer {res['dp_s']:.1f} s")
        if not (grad_rel <= PAR_GRAD_REL_L2 and upd_rel <= PAR_UPDATE_REL_L2
                and loss_rel <= PAR_LOSS_RTOL):
            errs.append(f"(a): rank {r}'s data-parallel step differs from one process")
        if res["dp_counts"] != per_step:
            errs.append(f"(a): rank {r} launched {res['dp_counts']}, want {per_step}")
        dp[f"rank{r}"] = row
    if one_counts != captured(per_step, 1):  # its graph's warm-up and capture
        errs.append(f"(a): the one-process step launched {one_counts}, want "
                    f"{captured(per_step, 1)}")
    dp["one_process_loss"] = one_losses[0]

    # (b) tp = 2 against the unsplit step
    ref = ranks[0]["tp_ref"]
    want_tp = want_counts(flash_attention_fwd=FLASH_PER_STEP, lora_dense=LORA_PER_STEP)
    tp = {}
    for r, res in enumerate(ranks):
        err = res["tp_eps"] - ref
        rel = float(err.norm() / ref.norm())
        mx = float(err.abs().max())
        log(f"phase 11 (b) rank {r}: eps rel L2 {rel:.3e} (gate {PAR_TP_REL_L2}), max |err| "
            f"{mx:.3e}; shard shapes {res['tp_shapes']}; launches "
            f"{res['tp_counts']} (want {want_tp}); {res['tp_ms']:.1f} ms a step "
            f"(two ranks on one card, gloo)")
        if not (rel <= PAR_TP_REL_L2 and torch.isfinite(err).all()):
            errs.append(f"(b): rank {r}'s tp=2 UNet step differs from the unsplit step")
        if res["tp_counts"] != want_tp:
            errs.append(f"(b): rank {r} launched {res['tp_counts']}, want {want_tp}")
        if res["tp_shapes"]["to_q"] != (160, 320) or res["tp_shapes"]["heads"] != 4:
            errs.append(f"(b): rank {r} holds shards {res['tp_shapes']}")
        tp[f"rank{r}"] = {"rel_l2": rel, "max_abs": mx, "ms": res["tp_ms"],
                          "launches": res["tp_counts"], "shapes": res["tp_shapes"]}

    # (c) an NCCL all-reduce captured in the step's graph; the trainer's own
    # graph is dropped, so that both runs capture afresh under
    # cudnn.deterministic (see phase_dreambooth_fp32)
    for attr in ("_dft_graphs", "_dft_jit_cache"):
        made["step_fn"].__dict__.pop(attr, None)
    tensors = carried_tensors(state)
    before = [t.detach().clone() for t in tensors]
    host_step = state["step"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    results, graph_counts = [], {}
    try:
        mesh = mesh_lib.make_mesh(1, device="cuda:0")
        for label, m in (("mesh-free", None), ("one-rank NCCL mesh", mesh)):
            with torch.no_grad():
                torch._foreach_copy_(tensors, before)
            state["step"] = host_step
            gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
            disp = FusedDispatcher(made["step_fn"], 1, mesh=m)
            reset_counts()
            t0 = time.perf_counter()
            state, losses = disp.run(state, [made["batch"]], gen)
            torch.cuda.synchronize()
            graph_counts[label] = counts()
            log(f"phase 11 (c) {label}: graphed step (capture and replay) "
                f"{time.perf_counter() - t0:.2f} s, loss {float(losses[0])!r}")
            results.append((losses.clone(), [t.detach().clone() for t in tensors]))
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    equal = torch.equal(results[0][0], results[1][0]) and all(
        torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))
    want_graph = captured(per_step, 1)
    log(f"phase 11 (c): the graphed step through a one-rank NCCL mesh equal to the mesh-free "
        f"graphed step: {equal} ({len(tensors)} tensors and the loss); launches "
        f"{graph_counts['one-rank NCCL mesh']} (want {want_graph})")
    if not equal:
        errs.append("(c): the NCCL-mesh graphed step differs from the mesh-free one")
    if any(c != want_graph for c in graph_counts.values()):
        errs.append(f"(c): graphed steps launched {graph_counts}, want {want_graph}")
    if errs:  # every part has run; all of its faults together
        fail("phase 11 " + "; ".join(errs))
    del state, made
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"parallel_dp_rank0": ranks[0]["dp_counts"],
                "parallel_dp_rank1": ranks[1]["dp_counts"],
                "parallel_tp_rank0": ranks[0]["tp_counts"],
                "parallel_tp_rank1": ranks[1]["tp_counts"],
                "parallel_nccl_graph": graph_counts["one-rank NCCL mesh"]}
    return launches, {"dp": dp, "tp": tp, "nccl_graph_equal": equal}


# ---------------------------------------------------------------------------
# phase 12: SD 2.1 (768-v) at full width
# ---------------------------------------------------------------------------

SD21_IMAGE = 768         # 96x96 latents, the model's sample_size
SD21_EAGER = 3           # timed eager 50-step requests
SD21_GRAPHED = 5         # timed graphed ones after the capturing call
SD21_TRAIN_REPLAYS = 5   # timed graphed train steps after the capturing one
SD21_DB_STEPS = 4
SD21_DB_SPD = 2          # the trainer's first dispatch captures, the second replays


def sd21_configs():
    """stabilityai/stable-diffusion-2-1: the UNet of its unet/config.json
    (heads (5, 10, 20, 20) of 64, cross-attention width 1024, linear
    proj_in/proj_out, sample_size 96), OpenCLIP ViT-H's text tower (23
    layers of width 1024, 16 heads, gelu), the SD VAE, v-prediction."""
    import dataclasses

    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig
    from diffusion_finetuning_tpu_torch.models.schedulers import SchedulerConfig
    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig
    from diffusion_finetuning_tpu_torch.models.vae import VAEConfig

    return (dataclasses.replace(UNetConfig.sd21(), sample_size=SD21_IMAGE // 8),
            VAEConfig.sd15(), CLIPTextConfig.sd21(),
            SchedulerConfig(prediction_type="v_prediction"))


def sd21_model_dir(pipe, tmp):
    """(a) ``phase_model_dir`` of the SD 2.1 pipe, and every SD2 field of the
    configs ``from_pretrained`` read.  Returns the loaded pipe, its
    directory and the row."""
    loaded, row = phase_model_dir(pipe, tmp, "sd21")
    u, t, sc = loaded.unet_config, loaded.text_config, loaded.scheduler_config
    fields = {"use_linear_projection": u.use_linear_projection,
              "attention_head_dim": tuple(u.attention_head_dim),
              "cross_attention_dim": u.cross_attention_dim, "sample_size": u.sample_size,
              "text hidden_act": t.hidden_act, "text layers": t.num_hidden_layers,
              "text width": t.hidden_size, "text heads": t.num_attention_heads,
              "prediction_type": sc.prediction_type}
    want = {"use_linear_projection": True, "attention_head_dim": (5, 10, 20, 20),
            "cross_attention_dim": 1024, "sample_size": 96, "text hidden_act": "gelu",
            "text layers": 23, "text width": 1024, "text heads": 16,
            "prediction_type": "v_prediction"}
    log(f"sd21 (a) SD2 fields read back: {fields}")
    if fields != want:
        fail(f"from_pretrained read the SD 2.1 directory as {fields}, want {want}")
    return loaded, os.path.join(tmp, "sd21"), dict(row, fields=fields)


def sd21_unet_step(pipe, ref_unet, lora_cpu, lora_dev):
    """(b) One CFG UNet step at 96x96 latents, bf16, dynamic LoRA: 32 K1 and
    144 K2, eager and through a CUDA graph (equal bit for bit), held against
    the same UNet in fp32 on the CPU (the kernels' plain versions)."""
    import torch

    from diffusion_finetuning_tpu_torch import lora as lora_lib
    from diffusion_finetuning_tpu_torch.graph import Graphs

    side = SD21_IMAGE // pipe.vae_scale_factor
    g = torch.Generator().manual_seed(SEED + 120)
    x = torch.randn((2, 4, side, side), generator=g).bfloat16()
    ctx = torch.randn((2, 77, pipe.unet_config.cross_attention_dim), generator=g).bfloat16()
    t = torch.tensor([500, 500])
    xd, td, cd = x.cuda(), t.cuda(), ctx.cuda()
    unet = pipe.unet
    per_step = want_counts(flash_attention_fwd=FLASH_PER_STEP, lora_dense=LORA_PER_STEP)
    with torch.inference_mode():
        with lora_lib.attached(unet, lora_dev):
            reset_counts()
            out = unet(xd, td, cd)
            torch.cuda.synchronize()
            eager_counts = counts()
            eager_ms = wall_ms(lambda: unet(xd, td, cd), 5)
            reset_counts()
            entry = Graphs(pipe.device).capture("sd21 unet step", lambda: unet(xd, td, cd))
            capture_counts = counts()
            equal = torch.equal(entry.replay(), out)
            graphed_ms = wall_ms(entry.replay, 10)
            replay_counts = counts()
        base = unet(xd, td, cd)
    log(f"sd21 (b) unet step 96x96: launches eager {eager_counts} (want {per_step}), at capture "
        f"{capture_counts}, after the replays {replay_counts}; ms eager {eager_ms:.3f}, graphed "
        f"{graphed_ms:.3f}; replay equal to eager {equal}")
    if eager_counts != per_step or capture_counts != captured(per_step, 1) or (
            replay_counts != capture_counts):
        fail("the SD 2.1 UNet step's launches are off")
    if not equal or not bool(torch.isfinite(out).all()):
        fail("the graphed SD 2.1 UNet step differs from the eager one, or is not finite")
    t0 = time.time()
    with torch.inference_mode(), lora_lib.attached(ref_unet, lora_cpu):
        ref = ref_unet(x.float(), t, ctx.float())
    _, rel = errors(out.cpu(), ref)
    _, lora_effect = errors(out.cpu(), base.cpu())
    log(f"sd21 (b) unet step, card bf16 vs CPU fp32 (plain versions): rel_l2={rel:.3e} (limit "
        f"{UNET_REL_L2}); the LoRA moves it by rel_l2={lora_effect:.3e}; CPU reference "
        f"{time.time() - t0:.1f} s")
    if not rel <= UNET_REL_L2:
        fail(f"the SD 2.1 UNet step disagrees with the CPU fp32 reference: {rel:.3e}")
    if not lora_effect > 4 * rel:
        fail("the LoRA barely moves the SD 2.1 UNet output: the comparison would not see it")
    return {"eager_ms": eager_ms, "graphed_ms": graphed_ms, "rel_l2": rel,
            "lora_effect_rel_l2": lora_effect, "launches": eager_counts,
            "capture_launches": capture_counts}


def sd21_serving(pipe, lora_dev):
    """(d) 768^2, 50 DDIM v-prediction steps, CFG 7.5, dynamic LoRA: eager
    requests, then the request graph (captured by the first graphed call)
    and SD21_GRAPHED timed replays, every graphed image equal to the eager
    one; first-call s, walls, peak memory, idle share, launches."""
    import torch

    pipe.unet_lora, pipe.materialize_lora = lora_dev, False
    kw = dict(seed=1, num_inference_steps=STEPS, guidance_scale=GUIDANCE, height=SD21_IMAGE,
              width=SD21_IMAGE, output_type="device")
    out = {"graphed": []}

    def run(graphs):
        old, pipe.cuda_graphs = pipe.cuda_graphs, graphs
        try:
            img = pipe("a photo of sks person", **kw)
        finally:
            pipe.cuda_graphs = old
        if graphs:
            out["graphed"].append(img)
        else:
            out["eager"] = img

    per_call = want_counts(flash_attention_fwd=FLASH_PER_STEP * STEPS,
                           lora_dense=LORA_PER_STEP * STEPS, group_norm=pipe_norms(pipe, STEPS))
    row = graphed_path("sd21_txt2img_768", lambda: run(False), lambda: run(True),
                       lambda: torch.equal(out["eager"], out["graphed"][-1]), per_call, 1,
                       eager_repeats=SD21_EAGER, graphed_repeats=SD21_GRAPHED)
    equal = [torch.equal(im, out["eager"]) for im in out["graphed"]]
    img = out["eager"]
    log(f"sd21 (d) {len(equal)} graphed images equal to the eager one: {sum(equal)}; image "
        f"{tuple(img.shape)} std {float(img.float().std()):.2f}")
    if len(equal) < 1 + SD21_GRAPHED or not all(equal):
        fail("a graphed SD 2.1 image differs from the eager one")
    if tuple(img.shape) != (1, SD21_IMAGE, SD21_IMAGE, 3) or not float(img.float().std()) > 0:
        fail("the SD 2.1 image is constant or misshapen")
    row["graphed_equal"] = len(equal)
    row["blocks_a_unet_call"] = check_blocks(pipe, SD_BLOCKS, "sd21")
    pipe.release_graphs()
    return row


def sd21_train(pipe, ucfg, vcfg, tcfg, sds, lora_cpu, ref_pipe):
    """(e) The bf16 train step at 768^2, batch 1, under the v-prediction
    target: one ``loss_step`` and backward against the CPU fp32 one (LoRA
    gradient rel L2), then ``build_train_step`` through ``jit_train_step``:
    the capture (twice a step's 32 K1, 32 K3, 144 K2) and timed replays
    (none), ms a step, peak memory, finite losses."""
    import torch

    from diffusion_finetuning_tpu_torch.models.schedulers import DDPMScheduler
    from diffusion_finetuning_tpu_torch.training.optim import ParamGroup, multi_group_optimizer
    from diffusion_finetuning_tpu_torch.training.train_step import (
        TrainablePartition, build_train_step, init_train_state, jit_train_step)

    batch = train_batch(pipe.tokenizer, seed=SEED + 140, side=SD21_IMAGE)
    reference, _ = phase_train_reference(
        pipe, ucfg, vcfg, tcfg, sds, lora_cpu, batch,
        cpu_models=(ref_pipe.unet, ref_pipe.text_encoder, ref_pipe.vae))
    opt = multi_group_optimizer({"unet_lora": ParamGroup(lr=TRAIN_LR)}, max_grad_norm=1.0)
    step = build_train_step(unet=pipe.unet, text_encoder=pipe.text_encoder, vae=pipe.vae,
                            scheduler=DDPMScheduler(pipe.scheduler_config), optimizer=opt,
                            partition=TrainablePartition(unet_lora=True))
    state = init_train_state(opt, unet_lora=lora_cpu)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 150)
    fused = jit_train_step(step)
    losses = []

    def one():
        losses.append(fused(state, batch, gen)[1]["loss"])

    per_step = want_counts(flash_attention_fwd=FLASH_PER_STEP,
                           flash_attention_bwd=FLASH_PER_STEP, lora_dense=LORA_PER_STEP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    at_capture = counts()
    walls = walls_ms(one, SD21_TRAIN_REPLAYS)
    after = counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    med = spread(walls)["median"]
    log(f"sd21 (e) graphed train step 768^2 batch 1 v-prediction: first call (capture) "
        f"{first_s:.2f} s, then ms {med:.3f} ({min(walls):.3f}-{max(walls):.3f}), "
        f"{1e3 / med:.3f} steps/s, peak memory {peak / 2**30:.3f} GiB; launches at capture "
        f"{at_capture} (want {captured(per_step, 1)}), after the replays {after}; losses "
        f"{[round(x, 5) for x in losses]}")
    if at_capture != captured(per_step, 1) or after != at_capture:
        fail("the SD 2.1 graphed train step's launches are off")
    if not all(math.isfinite(x) for x in losses):
        fail("an SD 2.1 train loss is not finite")
    return at_capture, {"reference": reference, "first_call_s": first_s,
                        "step_ms": spread(walls), "steps_per_s": 1e3 / med,
                        "peak_bytes": peak, "losses": losses}


def sd21_dreambooth(model_dir, tmp):
    """(f) ``train_lora_dreambooth`` from the SD 2.1 directory at 768^2 in
    its default fp32, batch 1, SD21_DB_STEPS steps at SD21_DB_SPD a graph:
    finite losses, exact fp32 launches (the capture's; the replay's none),
    steps/s after the capture, peak memory."""
    import torch

    from diffusion_finetuning_tpu_torch.training_scripts import train_lora_dreambooth as db

    inst = os.path.join(tmp, "sd21_instance")
    train_images(inst, SEED + 160, 2, side=SD21_IMAGE)
    args = ["--pretrained_model_name_or_path", model_dir, "--instance_data_dir", inst,
            "--instance_prompt", "a photo of sks person",
            "--output_dir", os.path.join(tmp, "sd21_dreambooth"),
            "--resolution", str(SD21_IMAGE), "--train_batch_size", "1",
            "--max_train_steps", str(SD21_DB_STEPS), "--save_steps", str(SD21_DB_STEPS),
            "--steps_per_dispatch", str(SD21_DB_SPD), "--learning_rate", "1e-4",
            "--lr_warmup_steps", "0", "--lora_rank", str(LORA_RANK), "--seed", str(SEED)]
    per_step = want_counts(flash_attention_fwd_fp32=FLASH_PER_STEP,
                           flash_attention_bwd_fp32=FLASH_PER_STEP,
                           lora_dense_fp32=LORA_PER_STEP)
    want = captured(per_step, SD21_DB_SPD)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state = db.main(db.parse_args(args))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    row = {"wall_s": wall, "train": check_phase_log(state["log"]["dispatch"],
                                                     "sd21 (f) DreamBooth fp32 768^2", want)}
    if got != want:
        fail(f"the SD 2.1 fp32 DreamBooth run launched {got}, want {want}")
    if state["step"] != SD21_DB_STEPS:
        fail(f"the SD 2.1 fp32 DreamBooth run reached step {state['step']}")
    log(f"sd21 (f) DreamBooth fp32: {wall:.1f} s")
    return got, row


def phase_sd21(tmp):
    """Phase 12: SD 2.1 (768-v) at its published widths, random weights from
    fixed seeds rounded to bf16 once, a rank-4 LoRA on the default targets,
    through the entry points: (a) save_pretrained / from_pretrained, (b) a
    CFG UNet step against the CPU fp32 one, (c) txt2img at 128^2 against
    the CPU fp32 pipe, (d) the 768^2 50-step image eager and graphed, (e) a
    bf16 graphed train step, (f) the fp32 DreamBooth trainer.  Returns the
    launches of each path and the numbers."""
    import torch

    t0 = time.time()
    ucfg, vcfg, tcfg, sched = sd21_configs()
    sds = random_weights(ucfg, vcfg, tcfg, seed=SEED + 100)
    lora_cpu = random_lora(ucfg, seed=SEED + 110)
    lora_dev = tree_to(lora_cpu, "cuda")
    built = build_pipe(ucfg, vcfg, tcfg, sds, torch.bfloat16, "cuda", sched)
    log(f"phase 12 models: {time.time() - t0:.1f} s")
    rows, launches = {}, {}
    pipe, model_dir, rows["model_dir"] = sd21_model_dir(built, tmp)
    del built
    pipe.cuda_graphs = False
    ref_pipe = build_pipe(ucfg, vcfg, tcfg, sds, torch.float32, "cpu", sched)
    log(f"phase 12 (a): {time.time() - t0:.1f} s")
    rows["unet_step"] = sd21_unet_step(pipe, ref_pipe.unet, lora_cpu, lora_dev)
    launches["sd21_unet_step"] = add_counts(rows["unet_step"]["launches"],
                                            rows["unet_step"]["capture_launches"])
    log(f"phase 12 (b): {time.time() - t0:.1f} s")
    reset_counts()
    phase_pipeline_reference(pipe, ref_pipe, lora_cpu, lora_dev)
    launches["sd21_txt2img_reference"] = counts()
    log(f"phase 12 (c): {time.time() - t0:.1f} s")
    rows["serving"] = sd21_serving(pipe, lora_dev)
    launches["sd21_serving"] = rows["serving"]["launches_at_capture"]
    check_no_fallbacks("phase 12")
    log(f"phase 12 (d): {time.time() - t0:.1f} s")
    launches["sd21_train"], rows["train"] = sd21_train(pipe, ucfg, vcfg, tcfg, sds, lora_cpu,
                                                       ref_pipe)
    del pipe, ref_pipe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12 (e): {time.time() - t0:.1f} s")
    launches["sd21_dreambooth_fp32"], rows["dreambooth_fp32"] = sd21_dreambooth(model_dir, tmp)
    log(f"phase 12 (f): {time.time() - t0:.1f} s")
    return launches, rows


# ---------------------------------------------------------------------------
# phase 13: SDXL 1.0 base
# ---------------------------------------------------------------------------

SDXL_IMAGE = 1024        # 128x128 latents, the model's sample_size
SDXL_STEPS = 20
SDXL_GUIDANCE = 8.0
SDXL_PROMPTS = ["a photo of sks person", "photo of sks"]
SDXL_GRAPHED = 2         # timed graphed batches after the capturing one
SDXL_BLOCKS = 70         # transformer blocks a UNet call: stacks of 2 x 2, 2 x 10, 10, 3 x 10, 3 x 2
SD_BLOCKS = 16           # SD 1.5's and 2.1's: one a transformer
SDXL_FLASH_PER_STEP = 2 * SDXL_BLOCKS   # 140 K1: each block's self- and cross-attention
SDXL_LORA_PER_STEP = 9 * SDXL_BLOCKS    # 630 K2: each block's nine projections
# the towers' LoRA'd projections, once a request: tower 1 to its penultimate
# layer (11 of 12), tower 2 whole (32)
SDXL_TEXT_LORA = 4 * (11 + 32)
# phase 2's SDXL rows, at the batch of cell sdxl_base.serve.batch_lora: 4
# images at 1024^2 with CFG, 8 rows.  (tokens, heads, width, transformer
# blocks a UNet call) by level: 10 heads of 64 at 640 wide over 64^2 tokens
# (2 down and 3 up transformers of 2 blocks), 20 at 1280 over 32^2 (2 down,
# the mid and 3 up of 10); cross-attention over 77 tokens, 2048 wide
SDXL_ROWS = 8
SDXL_FLASH, SDXL_LORA = [], []
for _s, _h, _c, _blocks in ((4096, 10, 640, 10), (1024, 20, 1280, 60)):
    SDXL_FLASH += [(SDXL_ROWS * _h, _s, _s, 64, _blocks), (SDXL_ROWS * _h, _s, 77, 64, _blocks)]
    SDXL_LORA += [(SDXL_ROWS * _s, _c, _c, 6 * _blocks), (77 * SDXL_ROWS, 2048, _c, 2 * _blocks),
                  (SDXL_ROWS * _s, _c, 8 * _c, _blocks)]
# the towers' (M, K, N, calls) over the 4 prompts (the unconditional half is zeros)
SDXL_TOWER_LORA = [(77 * 4, 768, 768, 4 * 11), (77 * 4, 1280, 1280, 4 * 32)]
assert sum(r[4] for r in SDXL_FLASH) == SDXL_FLASH_PER_STEP
assert sum(r[3] for r in SDXL_LORA) == SDXL_LORA_PER_STEP
assert sum(r[3] for r in SDXL_TOWER_LORA) == SDXL_TEXT_LORA


def sdxl_rows(gen, flush, iters):
    """Phase 2's rows at SDXL's shapes (phase 13's path), bf16 as served:
    K1 and K2 at the UNet's (``sdxl_per_step``: a CFG UNet step of 4
    images), K2 at the towers' (``sdxl_towers_per_request``), the NHWC
    GroupNorm at the UNet's and at the 1024^2 VAE decode's
    (``sdxl_vae_per_decode``).  Rows of their own, as ``sd21_rows``'s, each
    against its plain version within the gate of its SD1.5 rows, with its
    time, the library's and the bound."""
    import torch

    out = model_rows(gen, flush, iters, "sdxl", "SDXL", SDXL_FLASH,
                     (("serve", SDXL_LORA, "sdxl_per_step"),
                      ("request", SDXL_TOWER_LORA, "sdxl_towers_per_request")),
                     (torch.bfloat16,), backward=False)
    out = {name: rows for name, rows in out.items() if rows}
    out["group_norm"] = group_norm_rows(gen, flush, iters, SDXL_GN_SETS, fp32=False)
    return out


def unet_blocks_a_call(pipe):
    """``unet.transformer_blocks`` counted over one eager call of the pipe's
    UNet on 16x16 latents (SDXL's with zero added conditioning)."""
    import torch

    from diffusion_finetuning_tpu_torch.models import unet as unet_mod

    u = pipe.unet_config
    kw = dict(device=pipe.device, dtype=pipe.dtype)
    args = [torch.zeros((1, u.in_channels, 16, 16), **kw), torch.zeros(1, **kw),
            torch.zeros((1, 77, u.cross_attention_dim), **kw)]
    if u.text_time:
        args += [torch.zeros((1, pipe.text_config_2.projection_dim), **kw),
                 torch.zeros((1, 6), **kw)]
    before = unet_mod.transformer_blocks
    with torch.inference_mode():
        pipe.unet(*args)
    return unet_mod.transformer_blocks - before


def check_blocks(pipe, want, label):
    n = unet_blocks_a_call(pipe)
    log(f"{label}: unet.transformer_blocks a UNet call {n} (want {want})")
    if n != want:
        fail(f"the {label} UNet ran {n} transformer blocks a call, want {want}")
    return n


def sdxl_configs():
    """stabilityai/stable-diffusion-xl-base-1.0: its unet, text_encoder,
    text_encoder_2, vae and scheduler configs."""
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextConfig
    from diffusion_finetuning_tpu_torch.models.unet import UNetConfig
    from diffusion_finetuning_tpu_torch.models.vae import VAEConfig
    from diffusion_finetuning_tpu_torch.pipelines.pipeline_sdxl import SDXL_SCHEDULER

    return (UNetConfig.sdxl(), VAEConfig.sdxl(), CLIPTextConfig.sdxl_l(),
            CLIPTextConfig.sdxl_g(), SDXL_SCHEDULER)


def sdxl_pipe(seed=SEED + 200):
    """The SDXL pipe in bf16 on the card, each model with torch's default
    initialisation under a fixed seed, drawn on the card (2.6 B UNet
    weights are too slow to draw on the host)."""
    import torch

    from diffusion_finetuning_tpu_torch.data.tokenizer import CLIPTokenizer
    from diffusion_finetuning_tpu_torch.models.clip_text import CLIPTextModel
    from diffusion_finetuning_tpu_torch.models.unet import UNet2DConditionModel
    from diffusion_finetuning_tpu_torch.models.vae import AutoencoderKL
    from diffusion_finetuning_tpu_torch.pipelines.pipeline_sdxl import StableDiffusionXLPipeline

    ucfg, vcfg, t1, t2, sched = sdxl_configs()
    sds = []
    for i, (cls, cfg) in enumerate(((UNet2DConditionModel, ucfg), (AutoencoderKL, vcfg),
                                    (CLIPTextModel, t1), (CLIPTextModel, t2))):
        torch.manual_seed(seed + i)
        with torch.device("cuda"):
            m = cls(cfg)
        sds.append({k: v.to(torch.bfloat16) for k, v in m.state_dict().items()})
        del m
    words = ["photo", "of", "sks", "person"]
    return StableDiffusionXLPipeline(ucfg, sds[0], vcfg, sds[1], t1, sds[2],
                                     CLIPTokenizer.tiny(words), t2, sds[3],
                                     CLIPTokenizer.tiny(words), sched, dtype=torch.bfloat16,
                                     device="cuda")


def phase_sdxl():
    """Phase 13: SDXL 1.0 base at its published widths, random weights, a
    rank-4 dynamic LoRA on the UNet and both towers: a 1024^2 batch of 2
    (20 Euler steps, guidance 8, empty negative prompts) eager, then through
    its CUDA graph (``graphed_path``: equal bit for bit, launches twice a
    call at capture and none at replay).  An eager request must run 140 K1
    and 630 K2 a UNet step, 172 K2 in the towers, the predicted NHWC
    GroupNorms (the 1024^2 VAE levels among them) with no fallback, 70
    transformer blocks a UNet call and 2 towers.  Returns the launches and
    the row."""
    import torch

    from diffusion_finetuning_tpu_torch.models import clip_text, unet as unet_mod

    t0 = time.time()
    pipe = sdxl_pipe()
    ucfg, _, t1, t2, _ = sdxl_configs()
    pipe.unet_lora = tree_to(random_lora(ucfg, seed=SEED + 210), "cuda")
    pipe.text_encoder_lora = tree_to(random_text_lora(t1, SEED + 211), "cuda")
    pipe.text_encoder_2_lora = tree_to(random_text_lora(t2, SEED + 212), "cuda")
    pipe.materialize_lora = False
    log(f"phase 13 models: {time.time() - t0:.1f} s; weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    row = {"blocks_a_unet_call": check_blocks(pipe, SDXL_BLOCKS, "sdxl")}
    kw = dict(seed=[1, 2], num_inference_steps=SDXL_STEPS, guidance_scale=SDXL_GUIDANCE,
              height=SDXL_IMAGE, width=SDXL_IMAGE, scheduler="euler", output_type="device")
    per_call = want_counts(
        flash_attention_fwd=SDXL_FLASH_PER_STEP * SDXL_STEPS,
        lora_dense=SDXL_LORA_PER_STEP * SDXL_STEPS + SDXL_TEXT_LORA,
        group_norm=pipe_norms(pipe, SDXL_STEPS))
    out = {"graphed": []}

    def run(graphs):
        old, pipe.cuda_graphs = pipe.cuda_graphs, graphs
        try:
            img = pipe(SDXL_PROMPTS, **kw)
        finally:
            pipe.cuda_graphs = old
        if graphs:
            out["graphed"].append(img)
        else:
            out["eager"] = img

    reset_counts()
    blocks, towers = unet_mod.transformer_blocks, clip_text.towers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1_ = time.perf_counter()
    run(False)
    torch.cuda.synchronize()
    row["first_eager_s"] = time.perf_counter() - t1_
    row["eager_peak_bytes"] = torch.cuda.max_memory_allocated()
    launched = counts()
    row["launches_eager"] = launched
    row["transformer_blocks"] = unet_mod.transformer_blocks - blocks
    row["text_towers"] = clip_text.towers - towers
    log(f"sdxl eager batch of 2: {row['first_eager_s']:.2f} s, peak "
        f"{row['eager_peak_bytes'] / 2**30:.2f} GiB; launches {launched} (want {per_call}); "
        f"transformer blocks {row['transformer_blocks']} (want "
        f"{SDXL_BLOCKS * SDXL_STEPS}), towers {row['text_towers']} (want 2)")
    if launched != per_call:
        fail(f"the SDXL request launched {launched}, want {per_call}")
    if row["transformer_blocks"] != SDXL_BLOCKS * SDXL_STEPS or row["text_towers"] != 2:
        fail("the SDXL request ran another number of transformer blocks or towers")
    check_no_fallbacks("phase 13")
    img = out["eager"]
    if tuple(img.shape) != (2, SDXL_IMAGE, SDXL_IMAGE, 3) or not float(img.float().std()) > 0:
        fail(f"the SDXL images are constant or misshapen: {tuple(img.shape)}")
    row["graphed"] = graphed_path(
        "sdxl_txt2img_1024_b2", lambda: run(False), lambda: run(True),
        lambda: torch.equal(out["eager"], out["graphed"][-1]), per_call, 2,
        eager_repeats=1, graphed_repeats=SDXL_GRAPHED)
    equal = [torch.equal(im, out["eager"]) for im in out["graphed"]]
    log(f"sdxl {len(equal)} graphed batches equal to the eager one: {sum(equal)}")
    if len(equal) < 1 + SDXL_GRAPHED or not all(equal):
        fail("a graphed SDXL batch differs from the eager one")
    check_no_fallbacks("phase 13 graphed")
    launches = {"sdxl_txt2img": row["graphed"]["launches_at_capture"]}
    pipe.release_graphs()
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 13: {time.time() - t0:.1f} s")
    return launches, row


# kernel -> (route, source, the Pallas kernel it replaces, what its times sum over)
KERNEL_META = {
    "flash_attention_fwd": ("cuda", "diffusion_finetuning_tpu_torch/csrc/flash_attention.cu",
                            "diffusion_finetuning_tpu/ops/flash_attention.py:87", "unet_step"),
    "flash_attention_fwd_packed": (
        "cuda", "diffusion_finetuning_tpu_torch/csrc/flash_attention.cu",
        "diffusion_finetuning_tpu/ops/flash_attention.py:178", "unet_step"),
    "flash_attention_fwd_fp32": (
        "cuda", "diffusion_finetuning_tpu_torch/csrc/flash_attention_f32.cu",
        "diffusion_finetuning_tpu/ops/flash_attention.py:87", "unet_step"),
    "flash_attention_bwd": ("cuda", "diffusion_finetuning_tpu_torch/csrc/flash_attention_bwd.cu",
                            "diffusion_finetuning_tpu/ops/flash_attention.py:285", "train_step"),
    "flash_attention_bwd_fp32": (
        "cuda", "diffusion_finetuning_tpu_torch/csrc/flash_attention_bwd_f32.cu",
        "diffusion_finetuning_tpu/ops/flash_attention.py:285", "train_step"),
    "lora_dense": ("cuda", "diffusion_finetuning_tpu_torch/csrc/lora_matmul.cu",
                   "diffusion_finetuning_tpu/ops/lora_matmul.py:38", "unet_step"),
    "lora_dense_fp32": ("cuda", "diffusion_finetuning_tpu_torch/csrc/lora_matmul.cu",
                        "diffusion_finetuning_tpu/ops/lora_matmul.py:38", "unet_step"),
    "conv3x3": ("cuda", "diffusion_finetuning_tpu_torch/csrc/conv3x3.cu",
                "diffusion_finetuning_tpu/ops/conv_pallas.py:72", "unet_step"),
    "conv3x3_fp32": ("cuda", "diffusion_finetuning_tpu_torch/csrc/conv3x3.cu",
                     "diffusion_finetuning_tpu/ops/conv_pallas.py:72", "unet_step"),
    "group_norm": ("cuda", "diffusion_finetuning_tpu_torch/csrc/group_norm.cu",
                   "none: no TPU counterpart (XLA's GroupNorm)", "unet_step"),
}


def kernels_line(results, launches):
    """The kernels JSON: per kernel, times summed over one step's calls
    (each shape's time x its calls per step: a serving UNet step for the
    forward kernels, a train step for the backward), the worst error over
    shapes, and the launches of every main-path run ({path: {kernel: n}})
    summed, with the split by path beside them."""
    out = []
    for name, rows in results.items():
        route, source, replaces, per = KERNEL_META[name]
        step = lambda key: sum(r[key] * r["per_step"] for r in rows)
        ops_bound = sum(r["bound_ms"] * r["per_step"] for r in rows
                        if r["bound_by"] == "operations")
        by_path = {path: n.get(name, 0) for path, n in launches.items()}
        entry = dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=step("ms"), plain_ms=step("plain_ms"), bound_ms=step("bound_ms"),
            bound_by="operations" if ops_bound > step("bound_ms") / 2 else "bytes",
            library_ms=step("library_ms"), per=per, shapes=rows)
        # SD 2.1's rows (phase 12's path), summed over a 768^2 CFG UNet step
        # (a train step for the backward kernels), and SDXL's (phase 13's),
        # over a 1024^2 CFG UNet step of 4 images, a request's towers and a
        # VAE decode of 4, apart from the SD1.5 sums
        for key, key_per, n in (("sd21", per, "sd21_per_step"),
                                ("sd21_train", "train_step", "sd21_train_per_step"),
                                ("sdxl", per, "sdxl_per_step"),
                                ("sdxl_towers", "request", "sdxl_towers_per_request"),
                                ("sdxl_vae", "vae_decode", "sdxl_vae_per_decode")):
            some = [r for r in rows if r.get(n)]
            if some:
                entry[key] = dict(per=key_per, **{k: sum(r[k] * r[n] for r in some) for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms")})
        out.append(entry)
    return {"kernels": out}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also trace UNet steps and train steps (switches off and on) "
                         "with torch.profiler and write their per-kernel tables into DIR")
    # phase 11 starts this script again as each of its ranks
    ap.add_argument("--parallel-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if args.parallel_rank is not None:
        parallel_rank(args.parallel_rank, args.parallel_dir)
        return

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "diffusion_finetuning_tpu_torch")):
        fail("diffusion_finetuning_tpu_torch/ is not beside this script")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    phase_build()
    results = phase_kernels()
    log(f"phases 1-2: {time.time() - t0:.1f} s")

    t0 = time.time()
    ucfg, vcfg, tcfg = sd15_configs()
    sds = random_weights(ucfg, vcfg, tcfg)
    lora_cpu = random_lora(ucfg)
    lora_dev = tree_to(lora_cpu, "cuda")
    pipe = build_pipe(ucfg, vcfg, tcfg, sds, torch.bfloat16, "cuda")
    pipe.cuda_graphs = False  # phases 3-6 drive the eager requests, phase 7 the graphs
    log(f"models: {time.time() - t0:.1f} s")
    t0 = time.time()
    step, unet_ref = phase_unet_step(pipe, sds[0], lora_cpu, lora_dev, profile_dir=args.profile)
    log(f"phase 3: {time.time() - t0:.1f} s")
    t0 = time.time()
    ref_pipe = build_pipe(ucfg, vcfg, tcfg, sds, torch.float32, "cpu")
    phase_pipeline_reference(pipe, ref_pipe, lora_cpu, lora_dev)
    launches, serving = phase_serving(pipe, lora_dev)
    log(f"phase 4: {time.time() - t0:.1f} s")
    t0 = time.time()
    batch = train_batch(pipe.tokenizer)
    reference, train_ref = phase_train_reference(pipe, ucfg, vcfg, tcfg, sds, lora_cpu, batch)
    train_launches, train = phase_train(
        pipe, ucfg, lora_cpu, batch, want_counts(
            flash_attention_fwd=FLASH_PER_STEP, flash_attention_bwd=FLASH_PER_STEP,
            lora_dense=LORA_PER_STEP), profile_dir=args.profile)
    log(f"phase 5: {time.time() - t0:.1f} s")
    t0 = time.time()
    switched_paths, switched = phase_switched(
        pipe, ucfg, vcfg, tcfg, sds, lora_cpu, lora_dev, unet_ref, ref_pipe, batch, train_ref,
        profile_dir=args.profile)
    del ref_pipe
    log(f"phase 6: {time.time() - t0:.1f} s")
    t0 = time.time()
    graphed_launches, graphed = phase_graphed(pipe, ucfg, lora_cpu, lora_dev,
                                              profile_dir=args.profile)
    log(f"phase 7: {time.time() - t0:.1f} s")
    pipe.release_graphs()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.time()
        entry_launches, entry = phase_serving_entry(pipe, ucfg, tcfg, want_counts(
            flash_attention_fwd=FLASH_PER_STEP, lora_dense=LORA_PER_STEP), tmp)
        log(f"phase 8: {time.time() - t0:.1f} s")
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        trainer_launches, trainers = phase_trainers(os.path.join(tmp, "sd15"), tmp)
        log(f"phase 9: {time.time() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        rest_launches, rest = phase_rest_of_card(os.path.join(tmp, "sd15"), tmp)
        log(f"phase 10: {time.time() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        parallel_launches, parallel = phase_parallel(os.path.join(tmp, "sd15"), tmp)
        log(f"phase 11: {time.time() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        sd21_launches, sd21 = phase_sd21(tmp)
        log(f"phase 12: {time.time() - t0:.1f} s")
        sdxl_launches, sdxl = phase_sdxl()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(json.dumps({"unet_step": step, "serving": serving,
                    "train": dict(train, reference=reference), "switched": switched,
                    "graphed": graphed, "serving_entry": entry, "trainers": trainers,
                    "rest_of_card": rest, "parallel": parallel, "sd21": sd21, "sdxl": sdxl}))

    log(json.dumps(kernels_line(results, dict(
        {"serving": launches, "train": train_launches}, **switched_paths,
        graphed=graphed_launches, **entry_launches,
        **{f"trainer_{k}": v for k, v in trainer_launches.items()}, **rest_launches,
        **parallel_launches, **sd21_launches, **sdxl_launches))))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
