"""Map checkpoints between the two packages (``io/checkpoint.py``).

- A JAX checkpoint (``packed_matching`` False, with the ``[C, 256]``
  bipolar pool, and True, without it) loads in the port equal to
  ``mapstate.state_from_numpy`` of the JAX state, exactly.
- The port writes the JAX package's file: the port's state carried from
  the JAX run saves to the same leaves (``mp_bip`` rebuilt from the packed
  descriptors) and the same config bytes as the JAX checkpoint, and the JAX
  package resumes from it and tracks the next 4 frames with the same
  discrete outputs and poses as from its own checkpoint.
- The port saved after 4 frames, loaded and run for 4 more equals an
  uninterrupted 8-frame port run, exactly (local BA on; frames processed
  one at a time, so BA runs after the same frames in both).

320x240 synthetic frames; the JAX side in its float32 mode.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from torch_parity import small_cfgs, small_scene, x64_off  # noqa: F401
from rgbd_visualodometry_tpu.io import checkpoint as jckpt
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry as JaxVO
from rgbd_visualodometry_tpu_torch import VisualOdometry, mapstate
from rgbd_visualodometry_tpu_torch.io import checkpoint as tckpt
from rgbd_visualodometry_tpu_torch.io import synthetic

pytestmark = pytest.mark.usefixtures("x64_off")


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(8, scene=small_scene())


def _discrete(r):
    return (r.tracked, r.fsm, r.is_keyframe, r.stats)


@pytest.fixture(scope="module")
def jax_run(x64_off, seq, tmp_path_factory):
    """The JAX package (default matching: the bipolar pool) after 4 frames,
    its checkpoint, and a function resuming it from a checkpoint over
    frames 4-7."""
    _, jcfg = small_cfgs(packed_matching=False)
    vo = JaxVO(jcfg)
    for f in seq[:4]:
        vo.process(f.rgb, f.depth, f.timestamp)
    d = tmp_path_factory.mktemp("ckpt")
    path = str(d / "jax.npz")
    jckpt.save_state(vo.state, jcfg, path, meta={"time_base": vo.time_base})
    leaves = {k: np.asarray(v) for k, v in jax.device_get(jckpt.load_state(path)[0])._asdict().items()}

    def resume(ckpt):
        state, _, meta = jckpt.load_state(ckpt, with_meta=True)
        vo.state = jax.device_put(state, vo.device)
        vo.time_base = meta["time_base"]
        vo.results = []
        return [vo.process(f.rgb, f.depth, f.timestamp) for f in seq[4:]]

    return jcfg, path, leaves, resume, d


def _as_packed(jcfg, leaves, d):
    """The same map as the JAX package holds it under ``packed_matching``
    (no bipolar pool; matching gives the same results either way), saved
    by the JAX package."""
    jcfg = jcfg.replace(packed_matching=True)
    leaves = dict(leaves, mp_bip=np.zeros((leaves["mp_bip"].shape[0], 0), np.int8))
    from rgbd_visualodometry_tpu import mapstate as jms

    path = str(d / "jax_packed.npz")
    jckpt.save_state(jms.VOState(**leaves), jcfg, path, meta={"time_base": 7.0})
    return jcfg, leaves, path


@pytest.mark.parametrize("packed", [False, True])
def test_jax_checkpoint_loads_in_the_port(jax_run, seq, packed):
    jcfg, path, leaves, _, d = jax_run
    if packed:
        jcfg, leaves, path = _as_packed(jcfg, leaves, d)
    assert leaves["mp_bip"].shape[1] == (0 if packed else 256) and leaves["mp_valid"].sum() > 300
    state, cfg, meta = tckpt.load_state(path, with_meta=True, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert meta == {"time_base": 7.0 if packed else seq[0].timestamp}
    want = mapstate.state_from_numpy(leaves, device="cpu")
    for f in dataclasses.fields(mapstate.VOState):
        a, b = getattr(state, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    state2, cfg2 = tckpt.load_state(path, device="cpu")
    assert torch.equal(state2.obs_uv, want.obs_uv) and cfg2 == cfg


@pytest.mark.parametrize("packed", [False, True])
def test_port_checkpoint_equals_the_jax_one(jax_run, packed, tmp_path):
    jcfg, path, leaves, _, d = jax_run
    if packed:
        jcfg, leaves, path = _as_packed(jcfg, leaves, d)
    cfg, _ = small_cfgs(packed_matching=packed)
    port_path = str(tmp_path / "port.npz")
    meta = json.loads(bytes(np.load(path)["__meta__"]).decode())
    tckpt.save_state(mapstate.state_from_numpy(leaves, device="cpu"), cfg, port_path, meta=meta)
    with np.load(port_path) as got, np.load(path) as want:
        assert sorted(got.files) == sorted(want.files) and len(got.files) == len(tckpt.LEAVES) + 2
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_jax_resumes_from_a_port_checkpoint(jax_run, tmp_path):
    """The JAX package (bipolar pool) resumed from the port's checkpoint
    tracks frames 4-7 as it does from its own."""
    jcfg, path, leaves, resume, _ = jax_run
    cfg, _ = small_cfgs(packed_matching=False)
    port_path = str(tmp_path / "port.npz")
    state, _, meta = tckpt.load_state(path, with_meta=True, device="cpu")
    tckpt.save_state(state, cfg, port_path, meta=meta)
    want = resume(path)
    got = resume(port_path)
    assert all(r.tracked for r in want) and sum(r.stats["num_matches"] > 100 for r in want) == 4
    for a, b in zip(got, want):
        assert _discrete(a) == _discrete(b) and a.timestamp == b.timestamp
        assert a.pose_w_c.tobytes() == b.pose_w_c.tobytes()


def test_port_resume_equals_an_uninterrupted_run(seq, tmp_path):
    cfg, _ = small_cfgs(enable_local_optimization=True)
    whole = VisualOdometry(cfg, device="cpu")
    want = [whole.process(f.rgb, f.depth, f.timestamp) for f in seq]
    first = VisualOdometry(cfg, device="cpu")
    for f in seq[:4]:
        first.process(f.rgb, f.depth, f.timestamp)
    path = str(tmp_path / "map.npz")
    tckpt.save_state(first.state, cfg, path, meta={"time_base": first.time_base})
    state, cfg2, meta = tckpt.load_state(path, with_meta=True, device="cpu")
    assert cfg2 == cfg
    second = VisualOdometry(cfg, device="cpu")
    second.state, second.time_base = state, meta["time_base"]
    got = [second.process(f.rgb, f.depth, f.timestamp) for f in seq[4:]]
    assert whole.ba_dispatches >= 2 and all(r.tracked for r in want)
    for a, b in zip(got, want[4:]):
        assert _discrete(a) == _discrete(b) and a.timestamp == b.timestamp
        assert a.pose_w_c.tobytes() == b.pose_w_c.tobytes()
    for f in dataclasses.fields(mapstate.VOState):
        assert torch.equal(getattr(second.state, f.name), getattr(whole.state, f.name)), f.name


def test_load_state_refuses_other_files(tmp_path):
    cfg, _ = small_cfgs()
    path = str(tmp_path / "short.npz")
    np.savez(path, leaf_0=np.zeros(3), __config__=np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8))
    with pytest.raises(ValueError, match="state leaves"):
        tckpt.load_state(path, device="cpu")
