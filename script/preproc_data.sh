#!/usr/bin/env bash
# Run the four external predictors over an input video directory.
# The predictors (DPT, AlphaPose, ROMP, Mask2Former) are third-party
# GPU models pinned as submodules in the reference (survey §2.4); this
# framework CONSUMES their on-disk outputs:
#   <root>/images/img_%06d.jpg
#   <root>/AlphaPose/alphapose-results.json
#   <root>/DPT_large_monodepth/img_%06d.png    (16-bit disparity)
#   <root>/ROMP_Predictions/img_%06d.npz
#   <root>/Mask2Former_Instances/img_%06d.png  (uint8 person labels)
# Point the *_DIR variables at checkouts of the predictors and run, or
# produce the outputs any other way (they can run in parallel).
set -e

INPUT=${1:?usage: preproc_data.sh <video_frames_dir>}

echo "DPT:        python run_monodepth.py -i $INPUT/images -o $INPUT/DPT_large_monodepth -t dpt_large"
echo "AlphaPose:  python scripts/demo_inference.py --indir $INPUT/images --outdir $INPUT/AlphaPose --pose_track"
echo "ROMP:       romp --mode=video -i $INPUT/images -o $INPUT/ROMP_Predictions --save_npz"
echo "Mask2Former: python run_instance_segmentation.py -i $INPUT/images -o $INPUT/Mask2Former_Instances"
echo "(synthetic alternative for testing:"
echo "  python -c 'from mhmocap.data.synthetic import generate_sequence; generate_sequence(\"$INPUT\")')"
