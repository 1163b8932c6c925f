#!/bin/sh
# Equivalent of the reference tools/run_associate.sh: produce associate.txt
# for a TUM dataset directory.
DATASET=${1:?usage: run_associate_torch.sh <dataset_dir>}
python -m rgbd_visualodometry_tpu_torch.evaltools.cli associate \
    "$DATASET/rgb.txt" "$DATASET/depth.txt" > "$DATASET/associate.txt"
echo "wrote $DATASET/associate.txt"
