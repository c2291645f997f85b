#!/usr/bin/env bash
# Run the full MuPoTs TS1..TS20 prediction sweep
# (parity with reference script/predict_mupots_full.sh)
set -e
cd "$(dirname "$0")/.."

sel_sets=(1 2 3 4 5 6 7 8 9 10 11 12 13 14 15 16 17 18 19 20)
for ts in "${sel_sets[@]}"; do
  python -m mhmocap.predict_mupots \
    --configs_yml configs/predict_mupots.yml \
    --ts_id "$ts" \
    --output_path "./output/mupots"
done
