#!/usr/bin/env bash
# Quick smoke test: TS1 only at 100 iterations
# (parity with reference script/predict_mupots_test.sh)
set -e
cd "$(dirname "$0")/.."

python -m mhmocap.predict_mupots \
  --configs_yml configs/predict_mupots.yml \
  --ts_id 1 \
  --num_iter 100 \
  --output_path "./output/mupots-Test"
