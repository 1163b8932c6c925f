"""One tracking step of the port against the JAX package's ``track_step``
from the same state.

The JAX state after 5 frames is carried into the port with
``state_from_numpy``; both take one step on the same frame (normal
tracking, relocalization from LOST, localization-only), and the
``StepOutput`` record and every state leaf are compared.  Both see the same
pyramid levels (the reference's, see ``torch_parity.reference_pyramid``),
so ORB output is identical and the remaining differences are float32
rounding in RANSAC/LM/DLT.

Tolerances: flags, FSM, counts, slots, masks, the observation table, the
incidence matrix and the key exactly equal; poses within 1e-4 (translation,
m) and 0.01 degrees; float leaves within 1e-3 (positions re-triangulated
from poses that differ at that rounding level; pixels and depths copied).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import inject_reference_pyramid, quat_angle_deg, small_cfgs, small_scene, x64_off  # noqa: F401
from rgbd_visualodometry_tpu import mapstate as jms
from rgbd_visualodometry_tpu.pipeline.frontend import StepOutput as JaxStepOutput
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO
from rgbd_visualodometry_tpu_torch.io import synthetic
from rgbd_visualodometry_tpu_torch import mapstate as tms
from rgbd_visualodometry_tpu_torch.camera import Camera
from rgbd_visualodometry_tpu_torch.pipeline import frontend as tfe

pytestmark = pytest.mark.usefixtures("x64_off", "inject_reference_pyramid")


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(7, scene=small_scene())


@pytest.fixture(scope="module")
def run5(x64_off, seq):
    _, jcfg = small_cfgs()
    vo = JaxVO(jcfg)
    vo.run((f.rgb, f.depth, f.timestamp) for f in seq[:5])
    leaves = {k: np.asarray(v) for k, v in jax.device_get(vo.state)._asdict().items()}
    return vo, leaves


def _jax_step(vo, leaves, frame):
    state = jms.VOState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    new, out = vo._step(state, vo.put_frame(frame.rgb, frame.depth, frame.timestamp))
    return {k: np.asarray(v) for k, v in jax.device_get(new)._asdict().items()}, np.asarray(out.packed)


def _port_step(cfg, leaves, frame):
    state = tms.state_from_numpy(leaves, device="cpu")
    fin = tfe.frame_input(frame.rgb, frame.depth, frame.timestamp, "cpu")
    new, out = tfe.track_step(cfg, Camera.from_config(cfg), state, fin)
    return tms.state_to_numpy(new), out.packed.numpy()


def _compare(port, ref):
    (ps, po), (js, jo) = port, ref
    fields = JaxStepOutput._FIELDS
    for name, i in fields.items():
        assert po[i] == jo[i], f"{name}: port {po[i]} vs reference {jo[i]}"
    for sl in (slice(0, 7), slice(7, 14)):
        np.testing.assert_allclose(po[sl][4:], jo[sl][4:], atol=1e-4)
        assert quat_angle_deg(po[sl][:4], jo[sl][:4]) < 0.01
    for name, want in js.items():
        if name == "mp_bip":
            continue
        got = ps[name]
        assert got.shape == want.shape, name
        if np.issubdtype(want.dtype, np.floating):
            if name in ("kf_pose", "prev_pose"):
                # quaternions equal up to sign (Horn's eigenvector sign is free)
                q_g, q_w = got[..., :4], want[..., :4]
                sign = np.where(np.sum(q_g * q_w, axis=-1, keepdims=True) < 0, -1.0, 1.0)
                got = np.concatenate([q_g * sign, got[..., 4:]], axis=-1)
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    return po


def test_one_step_matches(run5, seq):
    vo, leaves = run5
    cfg, _ = small_cfgs()
    out = _compare(_port_step(cfg, leaves, seq[5]), _jax_step(vo, leaves, seq[5]))
    f = JaxStepOutput._FIELDS
    assert out[f["tracked"]] == 1 and out[f["num_matches"]] > 100


def test_keyframe_step_matches(run5, seq):
    """Frame 6 after frame 5: carries the port's own state through a second
    step, which inserts a keyframe, adds observations and creates points."""
    vo, leaves = run5
    cfg, _ = small_cfgs()
    jleaves, _ = _jax_step(vo, leaves, seq[5])
    out = _compare(_port_step(cfg, jleaves, seq[6]), _jax_step(vo, jleaves, seq[6]))
    f = JaxStepOutput._FIELDS
    assert out[f["is_keyframe"]] == 1 and out[f["num_new_mappoints"]] > 0


def test_relocalization_step_matches(run5, seq):
    """LOST with a stale pose: the whole alive map is the candidate set and
    a good relocalization re-anchors the map with a keyframe."""
    vo, leaves = run5
    cfg, _ = small_cfgs()
    lost = dict(leaves, fsm=np.int32(tms.LOST), lost_count=np.int32(0),
                prev_pose=np.array([1, 0, 0, 0, 0, 0, 0], np.float32))
    out = _compare(_port_step(cfg, lost, seq[3]), _jax_step(vo, lost, seq[3]))
    f = JaxStepOutput._FIELDS
    assert out[f["fsm"]] == tms.TRACKING and out[f["is_keyframe"]] == 1


def test_localization_only_step_matches(run5, seq):
    _, leaves = run5
    cfg, jcfg = small_cfgs(localization_only=True)
    vo = JaxVO(jcfg)
    vo.put_frame(seq[0].rgb, seq[0].depth, seq[0].timestamp)  # same time origin
    lost = dict(leaves, fsm=np.int32(tms.LOST), prev_pose=np.array([1, 0, 0, 0, 0, 0, 0], np.float32))
    out = _compare(_port_step(cfg, lost, seq[4]), _jax_step(vo, lost, seq[4]))
    f = JaxStepOutput._FIELDS
    assert out[f["tracked"]] == 1 and out[f["is_keyframe"]] == 0
