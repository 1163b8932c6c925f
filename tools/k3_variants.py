#!/usr/bin/env python3
"""Designs of kernel K3 (``hamming_matrix``) against each other on one GPU,
in turns, in one call.

    python3 tools/k3_variants.py [--source NAME=PATH ...] [--turns 3] [--out FILE]

Builds this checkout's ``rgbd_visualodometry_tpu_torch/csrc/hamming_nn.cu``
("head"), the variants of it in ``VARIANTS`` (textual substitutions, each
of which must match once) and every ``--source`` (another ``hamming_nn.cu``,
for example the parent's, unpacked with ``git archive`` into a gitignored
directory), each into a library of its own under
``rgbd_visualodometry_tpu_torch/_build/k3_variants/`` with the port's
``NVCC_FLAGS``, all ``nvcc`` processes at once.  Two variants skip part
of the work (the ``mma``s, or the global stores) and are timed only, to
show what each part costs.  Then, in ``--turns``
rounds (designs in order, reversed every other round), each design's C
entry ``rgbdvo_hamming_matrix`` runs at C x N = 65536 x 512 (the parity
bench's shape) and 16384 x 500 (the main path's pool) on seeded inputs: it
must equal ``matching.hamming_matrix_reference`` (unless timed only), then
its device time is
taken with ``chip_smoke._device_ms`` (torch.profiler, kernels whose name
holds ``hamming_matrix``), beside a store-only ``fill_`` of the same output
in the same round.  Prints the card, each design's registers, shared memory
and SASS counts, one line per measurement and the median per design and
shape, and writes all of it to ``--out`` if given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import statistics
import subprocess
import sys

HEAD = pathlib.Path(__file__).resolve().parent.parent
SHAPES = ((65536, 512), (16384, 500))
# name -> ([(text in head's source, its replacement)], exact); a variant
# that is not exact (it skips part of the work) is timed, not checked
VARIANTS = {
    "plain stores": ([("__stcs(p, v);", "*p = v;")], True),
    "4 warps per block": ([("constexpr int kMatSplits = 8;", "constexpr int kMatSplits = 4;")], True),
    "at most 4 blocks per SM": ([("constexpr int kMatBlocksPerSm = 2;", "constexpr int kMatBlocksPerSm = 4;")], True),
    "4 warps, at most 4 blocks per SM": ([("constexpr int kMatSplits = 8;", "constexpr int kMatSplits = 4;"),
                                          ("constexpr int kMatBlocksPerSm = 2;", "constexpr int kMatBlocksPerSm = 4;")], True),
    "no mma (timing only)": ([("mma_b1_and_popc(acc, a, words[8 * (j + g)",
                               "if (pa0 < 0) mma_b1_and_popc(acc, a, words[8 * (j + g)")], False),
    "no global stores (timing only)": ([("__stcs(p, v);", "if (sizeof(T) == 0) __stcs(p, v);")], False),
}


def build_all(sources: dict[str, str], out_dir: pathlib.Path) -> dict[str, tuple[pathlib.Path, str]]:
    """Compile every source into ``out_dir/<i>.so`` in parallel; returns
    name -> (library, ptxas report of ``hamming_matrix_kernel``)."""
    from rgbd_visualodometry_tpu_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, lib = out_dir / f"{i}.cu", out_dir / f"{i}.so"
        src.write_text(text)
        cmd = [nvcc, "--ptxas-options=-v", *kernels.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines, mine, report = log.splitlines(), False, []
        for ln in lines:  # the report lines after the kernel's "Compiling entry" line, up to the next one
            if "Compiling entry" in ln:
                mine = "hamming_matrix_kernel" in ln
            elif mine and ("Used" in ln or "spill" in ln):
                report.append(ln.split(":", 1)[-1].strip())
        built[name] = (lib, " | ".join(report))
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], help="NAME=PATH of another hamming_nn.cu")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--out", help="write every measurement here as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(HEAD))
    import numpy as np
    import torch

    import chip_smoke as cs
    from rgbd_visualodometry_tpu_torch import kernels
    from rgbd_visualodometry_tpu_torch.ops import matching

    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    head = (kernels.CSRC / "hamming_nn.cu").read_text()
    sources = {"head": head}
    exact = {"head": True}
    for name, (subs, exact[name]) in VARIANTS.items():
        text = head
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} occurs {text.count(old)} times in head's source")
            text = text.replace(old, new)
        sources[name] = text
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources[name] = pathlib.Path(path).read_text()
        exact[name] = True
    built = build_all(sources, kernels.BUILD_DIR / "k3_variants")
    entries = {}
    for name, (lib, ptxas) in built.items():
        fn = ctypes.CDLL(str(lib)).rgbdvo_hamming_matrix
        fn.argtypes = kernels.HAMMING_MATRIX.argtypes
        fn.restype = ctypes.c_int
        entries[name] = fn
        print(f"{name}: {ptxas}; SASS {cs.sass_summary(lib).get('hamming_matrix_kernel')}")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    inputs = {}
    for c, n in SHAPES:
        cand, kp = (torch.from_numpy(rng.integers(0, 2**32, (k, 8), dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)
                    for k in (c, n))
        inputs[c, n] = (cand, kp, torch.empty((c, n), dtype=torch.int32, device=dev),
                        matching.hamming_matrix_reference(cand, kp))

    def launcher(fn, cand, kp, out):
        c, n = cand.shape[0], kp.shape[0]

        def go():
            err = fn(cand.data_ptr(), kp.data_ptr(), c, n, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")

        return go

    rows = []
    names = list(entries)
    for turn in range(args.turns):
        for name in names if turn % 2 == 0 else names[::-1]:
            for (c, n), (cand, kp, out, want) in inputs.items():
                out.fill_(-1)
                go = launcher(entries[name], cand, kp, out)
                go()
                torch.cuda.synchronize()
                if exact[name] and not torch.equal(out, want):
                    raise AssertionError(f"{name} differs from the plain version at C={c}, N={n}")
                row = dict(turn=turn, design=name, C=c, N=n, device_ms=cs._device_ms(go, "hamming_matrix"),
                           fill_ms=cs._device_ms(lambda out=out: out.fill_(0), None), clocks=cs.sm_clocks())
                rows.append(row)
                print(json.dumps(row))
    summary = {}
    for name in names:
        for c, n in SHAPES:
            mine = [r for r in rows if r["design"] == name and (r["C"], r["N"]) == (c, n)]
            summary[f"{name} {c}x{n}"] = dict(
                device_ms=statistics.median(r["device_ms"] for r in mine),
                fill_ms=statistics.median(r["fill_ms"] for r in mine),
                device_ms_range=[min(r["device_ms"] for r in mine), max(r["device_ms"] for r in mine)],
            )
            print(f"{name} {c}x{n}, median of {len(mine)} turns: {json.dumps(summary[f'{name} {c}x{n}'])}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "ptxas": {k: v[1] for k, v in built.items()}, "rows": rows, "summary": summary},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
