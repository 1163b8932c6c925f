"""The JAX package's pure-Python modules, reused by file path.

``rgbd_visualodometry_tpu/__init__.py`` imports ``camera.py``, which imports
jax, so importing any submodule of that package the usual way pulls jax in.
The configuration (``config.py``), the synthetic sequence generator
(``io/synthetic.py``) and the TUM trajectory writer (``io/trajectory.py``)
use only the standard library, numpy and PyYAML.  They are loaded here
straight from their files, under private module names, so the port shares
one definition of ``VOConfig`` and of the synthetic scenes with the JAX
package without ever running its ``__init__``.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

_REF = pathlib.Path(__file__).resolve().parent.parent / "rgbd_visualodometry_tpu"


def _load(relpath: str, name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _REF / relpath)
    mod = importlib.util.module_from_spec(spec)
    # registered before exec: dataclasses resolves the string annotations
    # left by ``from __future__ import annotations`` through sys.modules
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


_config = _load("config.py", "_rgbd_vo_shared_config")
_synthetic = _load("io/synthetic.py", "_rgbd_vo_shared_synthetic")
_trajectory = _load("io/trajectory.py", "_rgbd_vo_shared_trajectory")

VOConfig = _config.VOConfig
load_config = _config.load_config
SyntheticScene = _synthetic.SyntheticScene
generate_sequence = _synthetic.generate_sequence
pose_inverse = _synthetic._pose_inverse
TrajectoryWriter = _trajectory.TrajectoryWriter

__all__ = [
    "VOConfig", "load_config", "SyntheticScene", "generate_sequence",
    "pose_inverse", "TrajectoryWriter",
]
