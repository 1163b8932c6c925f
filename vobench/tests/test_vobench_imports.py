"""What the harness and the reference load, compared by whole top-level
module names in a fresh process: the harness no jax, jaxlib, flax or the
JAX package; the reference not the port either."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "rgbd_visualodometry_tpu"}
PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), imports=imports)], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = _loaded("""
from vobench import harness, check, trace, frames, roofline
from rgbd_visualodometry_tpu_torch.parallel import MultiStreamVO, mesh
from rgbd_visualodometry_tpu_torch.pipeline import system, frontend, backend
bench = json.load(open({bench!r}))
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.load_reader(m["name"])
check.reference_modules()
""".replace("{bench!r}", repr(str(ROOT / "BENCHMARK.json"))))
    assert "rgbd_visualodometry_tpu_torch" in loaded and "vobench" in loaded
    assert not loaded & BANNED


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("""
from vobench.reference import camera, config, mapstate, random
from vobench.reference.pipeline import frontend, backend, globalopt
from vobench.reference.ops import loopclosure, posegraph
from vobench import check
check.reference_modules()
""")
    assert "vobench" in loaded
    assert not loaded & (BANNED | {"rgbd_visualodometry_tpu_torch"})
