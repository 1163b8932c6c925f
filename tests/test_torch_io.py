"""The port's own configuration and host-side IO against the JAX package's.

``rgbd_visualodometry_tpu_torch/config.py``, ``io/synthetic.py`` and
``io/trajectory.py`` are copies, so the port loads no file of the JAX
package; these tests hold each copy to its original: the same ``VOConfig``
fields, defaults and construction errors, the same parsed configs, byte-equal
synthetic frames and byte-equal trajectory files.  No tolerance: every
comparison is exact.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from rgbd_visualodometry_tpu import config as jconfig
from rgbd_visualodometry_tpu.io import synthetic as jsyn
from rgbd_visualodometry_tpu.io import trajectory as jtraj
from rgbd_visualodometry_tpu_torch import VOConfig, load_config
from rgbd_visualodometry_tpu_torch import config as tconfig
from rgbd_visualodometry_tpu_torch.io import synthetic as tsyn
from rgbd_visualodometry_tpu_torch.io import trajectory as ttraj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_voconfig_fields_and_defaults_equal():
    assert VOConfig is tconfig.VOConfig and load_config is tconfig.load_config
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(tconfig.VOConfig)]
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(jconfig.VOConfig)]
    assert got == want
    assert dataclasses.asdict(tconfig.VOConfig()) == dataclasses.asdict(jconfig.VOConfig())
    a = tconfig.VOConfig().replace(number_of_features=300, keyframe_eviction="refuse")
    b = jconfig.VOConfig().replace(number_of_features=300, keyframe_eviction="refuse")
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert hash(tconfig.VOConfig()) == hash(tconfig.VOConfig())


@pytest.mark.parametrize("bad", [
    dict(number_of_features=0), dict(level_pyramid=0), dict(scale_factor=1.0), dict(keyframe_eviction="lru"),
])
def test_voconfig_post_init_errors_equal(bad):
    with pytest.raises(ValueError) as want:
        jconfig.VOConfig(**bad)
    with pytest.raises(ValueError) as got:
        tconfig.VOConfig(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))))
def test_load_config_equal_on_the_repo_configs(path):
    assert dataclasses.asdict(tconfig.load_config(path)) == dataclasses.asdict(jconfig.load_config(path))


def test_opencv_yaml_parse_equal():
    text = "%YAML:1.0\ncamera.fx: 517.3\nnumber_of_features: 500\nenable_viewer: 0\n"
    assert tconfig._parse_opencv_yaml(text) == jconfig._parse_opencv_yaml(text)


@pytest.mark.parametrize("preset", ["default", "hard"])
def test_generate_sequence_byte_equal(preset):
    kw = dict(width=160, height=120, fx=129.3, fy=129.1, cx=79.6, cy=63.8)
    if preset == "hard":
        scenes = tsyn.hard_scene(**kw), jsyn.hard_scene(**kw)
    else:
        scenes = tsyn.SyntheticScene(**kw), jsyn.SyntheticScene(**kw)
    got = tsyn.generate_sequence(5, scene=scenes[0], step_t=(0.012, 0.002, 0.0), step_r=(0.0, 0.0, 0.003))
    want = jsyn.generate_sequence(5, scene=scenes[1], step_t=(0.012, 0.002, 0.0), step_r=(0.0, 0.0, 0.003))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.timestamp == b.timestamp
        for x, y in ((a.rgb, b.rgb), (a.depth, b.depth), (a.T_c_w, b.T_c_w)):
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        assert tsyn._pose_inverse(a.T_c_w).tobytes() == jsyn._pose_inverse(b.T_c_w).tobytes()
    for a, b in zip(tsyn.loop_trajectory(9), jsyn.loop_trajectory(9)):
        assert a.tobytes() == b.tobytes()


def test_trajectory_writer_byte_equal(tmp_path):
    rng = np.random.default_rng(7)
    poses = rng.normal(size=(6, 7))
    poses[:, :4] /= np.linalg.norm(poses[:, :4], axis=1, keepdims=True)
    ts = 1305031102.175304 + np.arange(6) / 30.0
    files = {}
    for name, mod in (("port", ttraj), ("jax", jtraj)):
        path = str(tmp_path / name / "traj.txt")
        with mod.TrajectoryWriter(path) as w:
            for t_, p in zip(ts[:4], poses[:4]):
                w.write(t_, p)
            w.rewrite(list(zip(ts[:3], poses[:3])))
            for t_, p in zip(ts[4:], poses[4:]):
                w.write(t_, p)
        files[name] = open(path, "rb").read()
        assert mod.pose_to_tum_line(ts[0], poses[0]) == jtraj.pose_to_tum_line(ts[0], poses[0])
    assert files["port"] == files["jax"]
    t_a, p_a = ttraj.read_trajectory(str(tmp_path / "port" / "traj.txt"))
    t_b, p_b = jtraj.read_trajectory(str(tmp_path / "jax" / "traj.txt"))
    assert t_a.tobytes() == t_b.tobytes() and p_a.tobytes() == p_b.tobytes() and len(t_a) == 5


# ---- the OpenCV YAML subset, parsed without PyYAML -------------------------

yaml = pytest.importorskip("yaml")


def _pyyaml(text):
    """What the reference path gives: PyYAML on the text without the
    ``%YAML`` directive and ``---`` lines (the JAX ``_parse_opencv_yaml``)."""
    lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML") and ln.strip() != "---"]
    return yaml.safe_load("\n".join(lines)) or {}


def _same(a: dict, b: dict) -> bool:
    """Dict equality with NaN equal to NaN and types compared too."""
    if list(a) != list(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if type(x) is not type(y):
            return False
        if isinstance(x, float) and x != x:
            if y == y:
                return False
        elif x != y:
            return False
    return True


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))))
def test_opencv_yaml_parse_equals_pyyaml_on_the_repo_configs(path):
    text = open(path, encoding="utf-8").read()
    got = tconfig._parse_opencv_yaml(text)
    assert _same(got, _pyyaml(text)) and _same(got, jconfig._parse_opencv_yaml(text))
    assert got["camera.fx"] == 517.3 and got["enable_viewer"] == 0 and got["dataset_dir"] == ""


def test_opencv_yaml_parse_equals_pyyaml_on_the_cli_test_config(tmp_path):
    from test_cli_dataset import small_yaml

    text = open(small_yaml(tmp_path, "/data/rgbd_dataset_freiburg1_xyz", "./out/traj.txt"), encoding="utf-8").read()
    got = tconfig._parse_opencv_yaml(text)
    assert _same(got, _pyyaml(text)) and len(got) == 28 and got["ba_max_points"] == 2048
    assert dataclasses.asdict(tconfig.VOConfig.from_dict(got)) == dataclasses.asdict(jconfig.VOConfig.from_dict(_pyyaml(text)))


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n", "a: [1, 2]\n", "a: {b: 1}\n", "- 1\n", "a: b: c\n", "a: 'open\n", "a: \"x\\q\"\n",
    "a: 'x' y\n", "  a: 1\n", "a: &anchor 1\n", "a: |\n  text\n",
])
def test_opencv_yaml_refuses_other_constructs(text):
    with pytest.raises(ValueError):
        tconfig._parse_opencv_yaml(text)


def _flat_configs():
    from hypothesis import strategies as st

    word = st.text(alphabet="abcdefghijklmnopqrstuvwxyzABCXYZ0123456789_./-", min_size=1, max_size=12)
    key = st.from_regex(r"[a-zA-Z][a-zA-Z0-9_.]{0,15}", fullmatch=True)
    scalar = st.one_of(
        st.integers(-10**12, 10**12).map(str),
        st.floats(allow_nan=False, allow_infinity=False).map(repr),
        st.sampled_from(["1.", "-0.5", ".5", "1.5e+3", "2.0E-2", "1e5", "0x1F", "017", "08", "0b101", "1_000", "1:30",
                         "+12", ".inf", "-.Inf", ".nan", "~", "null", "Null", "", "yes", "No", "ON", "off", "True",
                         "false", "y", "n", "2001-12-14x"]),
        word.filter(lambda w: w[0] not in "-"),
        st.text(alphabet="abc XYZ012#:-'", max_size=10).map(lambda s: "'" + s.replace("'", "''") + "'"),
        st.text(alphabet="abc XYZ012#:'\"\\\t", max_size=10).map(
            lambda s: '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace("\t", "\\t") + '"'),
    )
    comment = st.sampled_from(["", " # a comment", "   #x", " #"])
    line = st.tuples(key, scalar, comment).map(lambda t: f"{t[0]}: {t[1]}{t[2]}".rstrip() if t[1] == "" else f"{t[0]}: {t[1]}{t[2]}")
    extra = st.sampled_from(["", "# comment line", "   # indented comment", "---"])
    return st.lists(st.tuples(line, extra), min_size=1, max_size=12, unique_by=lambda t: t[0].split(":")[0]).map(
        lambda rows: "%YAML:1.0\n" + "".join(f"{ln}\n{x}\n" for ln, x in rows))


def test_opencv_yaml_parse_equals_pyyaml_on_generated_configs():
    from hypothesis import HealthCheck, given, settings

    @settings(max_examples=150, deadline=None, derandomize=True, suppress_health_check=list(HealthCheck))
    @given(_flat_configs())
    def check(text):
        want = _pyyaml(text)
        got = tconfig._parse_opencv_yaml(text)
        assert _same(got, want), (text, got, want)

    check()
