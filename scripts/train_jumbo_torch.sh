#!/bin/bash
# Jumbo-charset (~5,008-class) recognizer training with the PyTorch port,
# on the card: the recipe of scripts/train_jumbo.sh, with --device cuda in
# place of the JAX platform. The data comes from the port's glyph atlas
# (ppocr_tpu_torch/assets/glyph_atlas.npz): no PIL, cv2 or fontTools is
# needed where this runs. The det side needs no retrain.
# Both runs write under runs/ in the checkout (git ignores it).
set -euo pipefail
cd "$(dirname "$0")/.."
mkdir -p runs

# 1) pilot — 1k steps, warm start from the 218-class bundle's backbone
#    (the CTC head is re-sized to the jumbo charset automatically).
#    Decision gate: loss should fall well under ~30 and eval should show
#    exact matches appearing.
timeout 2400 python3 -u scripts/train_synthetic_rec_torch.py \
  --scene-crops --alphabet jumbo --img-w 256 --aug-rotate 8 \
  --steps 1000 --batch 32 --eval-batches 4 \
  --init-weights weights/rec_scene_full.npz --device cuda \
  --out runs/rec_jumbo_pilot.npz 2>&1 | tail -30

# 2) full run — fresh warm start (a clean cosine schedule over the full
#    step count). batch 48 ≈ 650k samples ≈ 130 per class.
timeout 14400 python3 -u scripts/train_synthetic_rec_torch.py \
  --scene-crops --alphabet jumbo --img-w 256 --aug-rotate 8 \
  --steps 14000 --batch 48 --eval-batches 6 \
  --init-weights weights/rec_scene_full.npz --device cuda \
  --out runs/rec_scene_jumbo_torch.npz 2>&1 | tail -40

# 3) gate — the trained-jumbo accuracy gate on both paths, on the card (f32,
#    TF32 off): the held-out protocol of ppocr_tpu_torch/train/eval_jumbo.py
#    (seeds 90210, 777, 31337 × 34 scenes). Exits non-zero below its bars
#    (staged ≥ 0.90 normalized and ≥ 0.62 raw, fused ≥ 0.90 and within 2
#    words of staged, det recall), which stops this script here.
python3 -u scripts/eval_jumbo_torch.py --both --device cuda \
  --rec runs/rec_scene_jumbo_torch.npz

# 4) serve it: copy runs/rec_scene_jumbo_torch.npz to
#    <model_dir>/rec/weights.npz beside weights/jumbo_keys.txt as <model_dir>/rec/ppocr_keys_v1.txt, with
#    weights/det_synthetic_text.npz as <model_dir>/det/weights.npz.
