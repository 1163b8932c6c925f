"""Contract-scale accuracy of the port on the CPU (marked ``slow``).

``tests/test_contract_parity.py``'s two 240-frame 640x480 sequences (fr1
intrinsics, 500 ORB features, the default ``VOConfig``: local BA, 65536 map
points), the easy textured plane of the bench and the fr1-like hard world,
through the cv2/numpy baseline twin (``baseline/opencv_vo.py``), the JAX
package and the port.  The port must track all but 2 frames and keep its
ATE at most 1.05x the twin's, the contract the JAX package is held to; the
JAX package's ATE is printed beside it, the only comparison of the two at
640x480 (the card has no jax).
"""

import importlib.util
import os
import time

import numpy as np
import pytest

from torch_parity import x64_off  # noqa: F401
from rgbd_visualodometry_tpu.config import VOConfig as JaxVOConfig
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO
from rgbd_visualodometry_tpu_torch import VOConfig, VisualOdometry
from rgbd_visualodometry_tpu_torch.evaltools import ate_rmse
from rgbd_visualodometry_tpu_torch.io import synthetic

pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("x64_off")]

W, H = 640, 480
N_FRAMES = 240
TRAJ = dict(step_t=(0.012, 0.002, 0.0), step_r=(0.0, 0.0, 0.003))  # the bench trajectory


def _twin_ate(seq):
    path = os.path.join(os.path.dirname(__file__), "..", "baseline", "opencv_vo.py")
    spec = importlib.util.spec_from_file_location("opencv_vo_torch_contract", os.path.abspath(path))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    res = twin.run(frames=seq)
    assert res["frames_tracked"] >= len(seq) - 2, res
    return res["ate_rmse_m"]


def _ate(vo, seq):
    t0 = time.perf_counter()
    results = vo.run((f.rgb, f.depth, f.timestamp) for f in seq)
    seconds = time.perf_counter() - t0
    tracked = [r for r in results if r.tracked]
    assert len(tracked) >= len(seq) - 2, f"tracked only {len(tracked)}/{len(seq)}"
    gt = [synthetic._pose_inverse(f.T_c_w)[4:7] for f in seq]
    ate = ate_rmse([r.timestamp for r in tracked], [r.pose_w_c[4:7] for r in tracked],
                   [f.timestamp for f in seq], gt)
    return ate, seconds


@pytest.mark.parametrize("world", ["easy", "hard"])
def test_port_contract_ate(world):
    scene = synthetic.SyntheticScene(width=W, height=H) if world == "easy" else synthetic.hard_scene(width=W, height=H)
    seq = synthetic.generate_sequence(N_FRAMES, scene=scene, **TRAJ)
    twin = _twin_ate(seq)
    port, port_s = _ate(VisualOdometry(VOConfig(), device="cpu"), seq)
    ref, ref_s = _ate(JaxVO(JaxVOConfig()), seq)
    print(f"\ncontract ({world}, {N_FRAMES} frames {W}x{H}, CPU): port ATE {port * 100:.3f} cm in {port_s:.0f} s, "
          f"JAX package {ref * 100:.3f} cm in {ref_s:.0f} s, twin {twin * 100:.3f} cm")
    assert np.isfinite(port) and port <= twin * 1.05, (
        f"contract ATE parity violated ({world}): port {port * 100:.2f} cm vs twin {twin * 100:.2f} cm")
