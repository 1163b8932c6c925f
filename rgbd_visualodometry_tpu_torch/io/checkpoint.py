"""Map-state checkpoint / resume, in the JAX package's ``.npz`` format.

Counterpart of ``rgbd_visualodometry_tpu/io/checkpoint.py``: every state
leaf is written as ``leaf_{i}`` in the field order of the JAX ``VOState``
(``rgbd_visualodometry_tpu/mapstate.py:69-110``), in its layout and dtypes
(C-minor pools, uint32 descriptor words, a uint32 ``[2]`` key), beside the
config and a small host-side ``meta`` as JSON.  So a checkpoint of either
package resumes in the other (``tests/test_torch_checkpoint.py``).  The
port's own state goes through :func:`mapstate.state_to_numpy` /
:func:`mapstate.state_from_numpy`.

The port keeps no ``[C, 256]`` bipolar descriptor pool (matching reads the
packed words).  The JAX package holds one unless ``packed_matching``, and
its loader checks no shapes, so the port writes ``mp_bip`` as the JAX
package would hold it: each mappoint row ever created (``mp_valid``) is its
packed descriptor unpacked to +-1 (``pallas_match.unpack_bipolar``), every
other row 0; ``[C, 0]`` under ``packed_matching``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from rgbd_visualodometry_tpu_torch import mapstate
from rgbd_visualodometry_tpu_torch.config import VOConfig

# the JAX VOState's fields, in order: the leaf_{i} names of a checkpoint
LEAVES = (
    "kf_pose", "kf_valid", "kf_timestamp", "num_kf",
    "mp_pos", "mp_desc", "mp_bip", "mp_norm", "mp_valid", "mp_outlier", "mp_triangulated", "mp_optimized",
    "obs_kf", "obs_uv", "obs_depth", "obs_valid",
    "A_inc",
    "ref_kf", "prev_pose", "fsm", "lost_count", "frame_index", "rng",
)


def _bipolar_pool(mp_desc: np.ndarray, mp_valid: np.ndarray) -> np.ndarray:
    """``mp_desc [8, C]`` uint32 words -> ``[C, 256]`` int8 +-1 (word-major,
    LSB first), 0 on rows never created."""
    bits = (mp_desc.T[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    bip = bits.reshape(mp_desc.shape[1], 256).astype(np.int8) * 2 - 1
    return np.where(mp_valid[:, None], bip, 0).astype(np.int8)


def save_state(state, cfg: VOConfig, path: str, meta: dict | None = None) -> None:
    """Serialize the port's state + config to ``path`` (.npz).

    ``meta`` holds small host-side session values that are not device state,
    e.g. ``time_base`` (the absolute float64 time origin - device timestamps
    are offsets; see ``VisualOdometry.time_base``)."""
    leaves = mapstate.state_to_numpy(state)
    if not cfg.packed_matching:
        leaves["mp_bip"] = _bipolar_pool(leaves["mp_desc"], leaves["mp_valid"])
    out = {f"leaf_{i}": leaves[name] for i, name in enumerate(LEAVES)}
    out["__config__"] = np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8)
    out["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **out)


def load_state(path: str, with_meta: bool = False, device="cuda"):
    """Restore ``(state, config)`` - or ``(state, config, meta)`` when
    ``with_meta`` - from a checkpoint of either package, the state on
    ``device`` (the card unless the caller asks for the CPU)."""
    with np.load(path) as data:
        cfg = VOConfig.from_dict(json.loads(bytes(data["__config__"]).decode()))
        missing = [f"leaf_{i}" for i in range(len(LEAVES)) if f"leaf_{i}" not in data]
        if missing or f"leaf_{len(LEAVES)}" in data:
            raise ValueError(f"{path}: not a checkpoint of {len(LEAVES)} state leaves")
        leaves = {name: data[f"leaf_{i}"] for i, name in enumerate(LEAVES)}
        meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
    state = mapstate.state_from_numpy(leaves, device=device)
    return (state, cfg, meta) if with_meta else (state, cfg)
