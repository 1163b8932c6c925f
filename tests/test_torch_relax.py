"""``VisualOdometry.global_relax`` end to end, the port against the JAX
package on the same 320x240 synthetic frames (``tests/test_loopclosure.py``'s
circuits, local BA on, float32 on both sides).

- The closed circuit (56 frames, 2.5 cm steps): the last leg revisits the
  first leg's map, so the co-observation graph holds long-gap loop edges.
  The port's own assertions are the reference test's: every frame tracked,
  at least one loop edge, the corrected trajectory no worse than 1.2x the
  streamed one (+0.1 mm) and the loop's end-to-start gap within 5 cm of
  the truth.  Beside them, each of the port's two ATEs (streamed and
  corrected) is at most 1.5x the JAX run's + 5 mm: the port's pyramid
  differs from ``jax.image.resize`` by ~1e-4 gray levels, which moves a few
  keypoints, so the two runs track and relax different maps.
- A live system relaxed after 14 frames keeps tracking (3 more frames),
  and the correction of a well-tracked run stays below 5 cm.
"""

import numpy as np
import pytest

from torch_parity import ground_truth, loop_frames, relax_cfgs, small_scene, x64_off  # noqa: F401
from rgbd_visualodometry_tpu.pipeline import globalopt as jgo
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO
from rgbd_visualodometry_tpu_torch import VisualOdometry
from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch.pipeline import globalopt

pytestmark = pytest.mark.usefixtures("x64_off")


def _closed_circuit(vo, relax_module, frames):
    """Run the circuit, relax with a 1 s loop gap; returns (report, ATE of
    the streamed poses, ATE of the corrected poses, corrected poses)."""
    results = vo.run((f.rgb, f.depth, f.timestamp) for f in frames)
    assert len(results) == len(frames) and all(r.tracked for r in results)
    report = vo.global_relax(loop_gap_s=1.0)
    gt_ts, gt_xyz = ground_truth(frames)
    est_ts = np.asarray([r.timestamp for r in results])
    est = np.asarray([r.pose_w_c for r in results])
    corrected = np.asarray(relax_module.correct_trajectory(report, est_ts - vo.time_base, est))
    return (report, ate_rmse(est_ts, est[:, 4:7], gt_ts, gt_xyz),
            ate_rmse(est_ts, corrected[:, 4:7], gt_ts, gt_xyz), corrected)


def test_loop_trajectory_revisit_closes_loop():
    frames = loop_frames(56, step=0.025)
    cfg, jcfg = relax_cfgs()
    report, before, after, corrected = _closed_circuit(VisualOdometry(cfg, device="cpu"), globalopt, frames)
    assert report.num_loop_edges >= 1  # the revisit closed the loop
    assert report.kf_ts.size >= 2 and np.isfinite(corrected).all()
    assert after <= before * 1.2 + 1e-4
    _, gt_xyz = ground_truth(frames)
    gap = np.linalg.norm(corrected[-1, 4:7] - corrected[0, 4:7])
    assert abs(gap - np.linalg.norm(gt_xyz[-1] - gt_xyz[0])) < 0.05

    jreport, jbefore, jafter, _ = _closed_circuit(JaxVO(jcfg), jgo, frames)
    assert jreport.num_loop_edges >= 1
    assert before <= 1.5 * jbefore + 5e-3, (before, jbefore)
    assert after <= 1.5 * jafter + 5e-3, (after, jafter)


def test_global_relax_on_live_system():
    cfg, _ = relax_cfgs()
    seq = synthetic.generate_sequence(17, scene=small_scene())
    vo = VisualOdometry(cfg, device="cpu")
    results = vo.run((f.rgb, f.depth, f.timestamp) for f in seq[:14])
    assert all(r.tracked for r in results)
    report = vo.global_relax()
    assert report.num_edges >= 1
    assert report.max_correction_m < 0.05  # a well-tracked short run needs only a tiny correction
    for f in seq[14:]:  # the relaxed state is still a coherent tracking state
        assert vo.process(f.rgb, f.depth, f.timestamp).tracked
    offs = np.asarray([r.timestamp for r in results]) - vo.time_base
    poses = np.asarray([r.pose_w_c for r in results])
    corrected = globalopt.correct_trajectory(report, offs, poses)
    assert np.max(np.linalg.norm(corrected[:, 4:7] - poses[:, 4:7], axis=-1)) < 0.05
