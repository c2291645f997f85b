#!/usr/bin/env bash
# Evaluate MuPoTs predictions -> FinalResults.{json,md}
# (parity with reference script/eval_mupots.sh)
set -e
cd "$(dirname "$0")/.."

python -m mhmocap.eval_mupots \
  --configs_yml configs/eval_mupots.yml \
  --input_path "./output/mupots"
