#!/bin/sh
# Equivalent of the reference tools/run_ate.sh: ATE of an estimated
# trajectory against groundtruth.txt (TUM format), with the same
# --plot png output (tools/run_ate.sh:1-7).
GT=${1:?usage: run_ate_torch.sh <groundtruth.txt> <estimate.txt> [plot.png]}
EST=${2:?usage: run_ate_torch.sh <groundtruth.txt> <estimate.txt> [plot.png]}
PLOT=${3:-}
if [ -n "$PLOT" ]; then
  python -m rgbd_visualodometry_tpu_torch.evaltools.cli ate "$GT" "$EST" --verbose --plot "$PLOT"
else
  python -m rgbd_visualodometry_tpu_torch.evaltools.cli ate "$GT" "$EST" --verbose
fi
