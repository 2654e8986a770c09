#!/bin/bash
# Full-schedule flagship training: the reference's
# 10,000-optimizer-step CyclicLR schedule (conf/model/tomosar2height.yaml:40-44)
# run end-to-end on the bench city with the production path (plain XLA
# scatters, bf16 trunk, det_stream checkpointed patch stream).
#
# Step size: batch 8 x optimize_every 2 = 16 patches/optimizer step (the
# reference's 64-patch step is 4x the work per step; this runs the FULL
# schedule — all 10 triangular2 LR cycles, every checkpoint/val/vis cadence.
# Throughput is measured separately by bench.py --train).
#
# Invocations resume from the latest checkpoint, so job timeouts double as
# the kill-and-resume evidence (det_stream makes the resume bit-consistent —
# tests/test_resume_bitexact.py pins that on CPU).
set -u
cd "$(dirname "$0")/.."
# Own city dir — NEVER share .bench/city with bench.py: an earlier draft
# regenerated that city at the make_synthetic_city default density (0.6)
# and silently invalidated the e2e bench numbers measured after it.
# 0.055 pts/m^2 is the density that fills the 16k bucket without overflow.
ROOT=$PWD/.bench/city_flagship
OUT=$PWD/.bench/outputs
RUN="$OUT/TomoSAR2Height-synthetic-flagship10k"

if [ ! -f "$ROOT/raster/ndsm.tif" ]; then
  echo "=== generating flagship city ==="
  python scripts/make_synthetic_city.py --out "$ROOT" --seed 0 --density 0.055
fi

OV="dataset=synthetic dataset.path=$ROOT/generated gt_dsm=$ROOT/raster/ndsm.tif \
input_pointcloud_folder=$ROOT/cloud output.output_folder=$ROOT/generated \
mask_files.building=$ROOT/raster/footprint.tif \
dataset.mask_files.building=$ROOT/raster/footprint.tif \
dataset.mask_files.type=$ROOT/raster/building_class.tif \
dataset.satellite_image.folder=$ROOT/raster \
use_cloud=true use_image=false use_footprint=false \
dataset.points.train_bucket=16384 dataset.points.bucket_sizes=[16384] \
training.out_dir=$OUT run_suffix=-flagship10k \
training.batch_size=8 training.optimize_every=2 training.max_iteration=10000 \
training.validate_every=100 training.checkpoint_every=100 \
training.visualize_every=1000 model.dtype=bfloat16 \
dataloader.n_workers=2"

if [ ! -d "$ROOT/generated/chunk_000" ]; then
  echo "=== building dataset ==="
  python scripts/build_dataset.py $OV
fi

for attempt in $(seq 1 12); do
  LATEST=$(ls "$RUN"/check_points/model_*.ckpt 2>/dev/null \
           | grep -v best | sed 's/.*model_\([0-9]*\).ckpt/\1 &/' \
           | sort -n | tail -1 | cut -d' ' -f2)
  N=$(echo "${LATEST:-}" | sed 's/.*model_\([0-9]*\).ckpt/\1/')
  [ -n "${N:-}" ] && [ "$N" -ge 10000 ] && break
  EXTRA=""
  [ -n "${LATEST:-}" ] && EXTRA="training.resume_from=$LATEST"
  echo "=== flagship 10k attempt $attempt (resume: ${LATEST:-none}) $(date -u +%FT%TZ) ==="
  timeout "${FLAGSHIP_TIMEOUT:-3300}" python train.py $OV $EXTRA && break
done
echo "=== final $(date -u +%FT%TZ): tail of metrics ==="
grep -h loss_l1 "$RUN"/wandb/metrics.jsonl 2>/dev/null | tail -10
