#!/usr/bin/env bash
# Predict on an arbitrary preprocessed video directory
# (parity with reference script/predict_internet.sh)
set -e
cd "$(dirname "$0")/.."

python -m mhmocap.predict_internet \
  --configs_yml configs/default.yml \
  --output_path "./output/internet"
