#!/bin/sh
# Equivalent of the reference tools/run_rpe.sh: fixed-delta (1 s) RPE,
# with the same --plot png output (tools/run_rpe.sh:1-8).
GT=${1:?usage: run_rpe_torch.sh <groundtruth.txt> <estimate.txt> [plot.png]}
EST=${2:?usage: run_rpe_torch.sh <groundtruth.txt> <estimate.txt> [plot.png]}
PLOT=${3:-}
if [ -n "$PLOT" ]; then
  python -m rgbd_visualodometry_tpu_torch.evaltools.cli rpe "$GT" "$EST" --fixed_delta --delta 1.0 --verbose --plot "$PLOT"
else
  python -m rgbd_visualodometry_tpu_torch.evaltools.cli rpe "$GT" "$EST" --fixed_delta --delta 1.0 --verbose
fi
