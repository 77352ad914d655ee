#!/usr/bin/env bash
# The PyTorch port's twin of tools/ab_synthetic.sh, arm grid_baseline: train
# the frozen synthetic recipe (tools/ab_base_synthetic.yaml: packed2x2
# sampling + grid points, B = 8, 512 px LSJ, bfloat16, 3000 iterations, the
# encoder recomputed in the backward) with `python -m
# mp_former_tpu_torch.train_net`, then evaluate the checkpoints at 1000, 2000
# and 3000 iterations with the shared eval settings of tools/ab_synthetic.sh,
# and summarise metrics.json.
#
# The data: tools/make_synthetic_coco_torch.py writes the train split with its
# defaults (200 images of 640 px, 20 classes) and a val split of 30 images
# (seed 1) under $DETECTRON2_DATASETS (default output/synth_coco_torch), unless
# they are there already. Training resumes from the last checkpoint under the
# output directory, so a run cut short by a time limit goes on where it
# stopped; a checkpoint that is not there yet is not evaluated.
#
# Usage: tools/ab_synthetic_torch.sh [outdir] [KEY VALUE ...]
#   (the overrides go to training and evaluation alike)
set -euo pipefail
cd "$(dirname "$0")/.."

OUT="${1:-output/ab_torch_grid_baseline}"
shift || true
export DETECTRON2_DATASETS="${DETECTRON2_DATASETS:-output/synth_coco_torch}"
if [ ! -f "$DETECTRON2_DATASETS/coco/annotations/instances_val2017.json" ]; then
  python3 tools/make_synthetic_coco_torch.py --root "$DETECTRON2_DATASETS" --split train2017
  python3 tools/make_synthetic_coco_torch.py --root "$DETECTRON2_DATASETS" --split val2017 \
    --images 30 --seed 1
fi

echo "=== train -> $OUT"
python3 -m mp_former_tpu_torch.train_net --config-file tools/ab_base_synthetic.yaml --resume \
  OUTPUT_DIR "$OUT" "$@"

for it in 1000 2000 3000; do
  ckpt=$(printf "%s/checkpoints/model_%07d.pth" "$OUT" "$it")
  [ -f "$ckpt" ] || { echo "=== no checkpoint at $it"; continue; }
  echo "=== eval $ckpt"
  python3 -m mp_former_tpu_torch.train_net --config-file tools/ab_base_synthetic.yaml --eval-only \
    MODEL.WEIGHTS "$ckpt" \
    MODEL.MASK_FORMER.TEST.INSTANCE_ON True \
    MODEL.MASK_FORMER.TEST.SEMANTIC_ON False \
    MODEL.MASK_FORMER.TEST.OBJECT_MASK_THRESHOLD 0.8 \
    MODEL.MASK_FORMER.TEST.OVERLAP_THRESHOLD 0.8 \
    INPUT.MIN_SIZE_TEST 512 INPUT.MAX_SIZE_TEST 512 \
    TEST.DETECTIONS_PER_IMAGE 100 TPU.MAX_INSTANCES 100 \
    OUTPUT_DIR "$OUT/eval_$it" "$@" 2>&1 | tee "$OUT/eval_$it.log" | tail -n 1
done

echo "=== metrics.json: total loss and seconds a step, by 500 iterations"
python3 - "$OUT/metrics.json" <<'EOF'
import json
import sys

lines = [json.loads(x) for x in open(sys.argv[1])]
for start in range(0, max(x["iteration"] for x in lines) + 1, 500):
    part = [x for x in lines if start <= x["iteration"] < start + 500]
    if part:
        loss = [x["total_loss"] for x in part]
        secs = [x["time"] for x in part if "time" in x and x["iteration"] > start]
        print(f"iterations {start}-{start + 499}: lines {len(part)} total_loss first "
              f"{loss[0]:.3f} mean {sum(loss) / len(loss):.3f} last {loss[-1]:.3f}; "
              f"s/step mean {sum(secs) / max(len(secs), 1):.4f}; data_time "
              f"{part[-1]['data_time']:.4f}")
EOF
