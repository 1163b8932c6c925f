"""A configuration, a traffic mix, a cell and a per-layer metric are added by
new files and new ``BENCHMARK.json`` entries alone: in a copy, the harness
of the copy finds and runs them, with no file of ``vobench`` edited."""

import hashlib
import json
import pathlib
import subprocess
import sys

from vobench.tests.tiny import REPO, TINY, tiny_copy

READER = '''"""Steps of the traced window."""


def read(run):
    return run.trace.steps if run.trace is not None else None
'''
SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.append({repo!r})
from vobench import harness
assert harness.__file__.startswith({root!r})
r = harness.run_cell(harness.load_cell("added_cell"), 2**33 + 5, 14.0, True, device="cpu")
print(json.dumps(r))
"""


def _digests(here: pathlib.Path) -> dict:
    return {p.relative_to(here).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in here.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_suffice(tmp_path):
    here = tiny_copy(tmp_path, streams=2)
    before = _digests(here)
    (here / "configs" / "added_config.json").write_text(json.dumps(
        dict(name="added_config", entry="MultiStreamVO", settings=dict(TINY, packed_matching=True, ba_min_frame_gap=2))))
    mix = json.loads((here / "traffic" / "tiny_mix.json").read_text())
    mix.update(name="added_mix", peak_step_m=[0.008, 0.004, 0.0])
    (here / "traffic" / "added_mix.json").write_text(json.dumps(mix))
    (here / "limits" / "added_cell.json").write_text((here / "limits" / "tiny_fleet.json").read_text())
    (here / "metrics" / "added.traced_steps.py").write_text(READER)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="added_config", source="test", file="vobench/configs/added_config.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="added_cell", config="added_config", traffic="added_mix", chips=1, why="test"))
    bench["per_layer"].append(dict(name="added.traced_steps", unit="steps", better="higher", source="program_span",
                                   layer="Host loop", moves="frames_per_s", workloads=["added_cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(tmp_path), repo=str(REPO))],
                         capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["metrics"]["added.traced_steps"]["value"] >= 2
