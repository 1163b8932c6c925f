"""Configuration system.

The PyTorch port's own copy of ``rgbd_visualodometry_tpu/config.py``,
identical in behaviour (``tests/test_torch_io.py`` holds the two
together).  It uses the standard library only - its own parser of the
OpenCV YAML subset stands in for PyYAML - so the port loads no file of the
JAX package and needs no YAML library.

Replaces the reference's OpenCV ``FileStorage`` YAML singleton
(``include/myslam/config.h:27-47``, ``src/config.cpp:25-42``) with a frozen
dataclass.  All 16 keys of the reference ``config/default.yaml:1-31`` are
preserved verbatim so reference config files load unmodified; the dataclass is
hashable so it can be passed as a static argument to jitted step functions
(capacities and thresholds become compile-time constants, which is what XLA's
static-shape model wants).

Extra, TPU-only keys (fixed capacities, RANSAC lane counts, ...) have defaults
mirroring the reference's hard-coded constants, e.g. RANSAC 100 iters / 4 px /
P3P seeded with the previous pose (``src/frontend.cpp:238-241``) and Huber
delta sqrt(7.815) with 10+10 LM iterations (``src/frontend.cpp:282-310``,
``src/backend.cpp:84,141,159``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class VOConfig:
    # ---- reference keys (config/default.yaml:1-31), names kept verbatim ----
    dataset_dir: str = ""
    output_file: str = "./output/output.txt"
    camera_fx: float = 517.3
    camera_fy: float = 516.5
    camera_cx: float = 318.6
    camera_cy: float = 255.3
    camera_depth_scale: float = 5000.0
    number_of_features: int = 500
    scale_factor: float = 1.2
    level_pyramid: int = 8
    match_ratio: float = 2.0
    max_num_lost: int = 10
    min_inliers: int = 10
    keyframe_rotation: float = 0.05
    keyframe_translation: float = 0.05
    enable_local_optimization: bool = True
    chi2_th: float = 1.0
    enable_viewer: bool = False
    # live-viewer output (the reference renders per-frame: keypoint overlay
    # viewer.cpp:144-150 + map/frustum view viewer.cpp:34-54; headless here)
    viewer_dir: str = "viewer_out"
    viewer_map_every: int = 10  # render the map view every N frames

    # ---- image geometry (TUM Kinect: 640x480, README.md:52) ----
    image_width: int = 640
    image_height: int = 480

    # ---- ORB frontend (defaults follow cv::ORB defaults used at
    #      src/frontend.cpp:35-37: edgeThreshold=31, patchSize=31,
    #      fastThreshold=20, Harris ranking) ----
    fast_threshold: int = 20
    edge_threshold: int = 31
    descriptor_pairs: int = 256  # rBRIEF bits

    # ---- matching (src/frontend.cpp:190-211): keep matches with
    #      dist <= max(min_dis * match_ratio, min_match_distance) ----
    min_match_distance: float = 30.0

    # ---- RANSAC PnP (src/frontend.cpp:238-241): the reference runs 100
    #      sequential P3P iterations @ 4 px / 0.99 conf; we evaluate
    #      `ransac_hypotheses` lanes in parallel. ----
    ransac_hypotheses: int = 128
    ransac_reproj_threshold: float = 4.0
    # fraction of hypothesis lanes solved WITHOUT the depth channel (3-point
    # Gauss-Newton from the seed pose - the reference's P3P likewise never
    # reads depth, src/frontend.cpp:238-241); keeps tracking alive through
    # Kinect-scale depth dropout where every depth lane would resample the
    # same few depth-valid matches
    ransac_depth_free_fraction: float = 0.25
    # fixed capacity for packed matched-correspondence slots fed to
    # RANSAC/LM (the reference's dynamically-sized pts3d/pts2d vectors,
    # src/frontend.cpp:219-230)
    pnp_max_points: int = 1024

    # ---- pose-only BA (src/frontend.cpp:256-312) ----
    huber_delta: float = math.sqrt(7.815)
    pose_ba_iterations: int = 10  # per round; two rounds as in the reference
    pose_chi2_outlier: float = 1.0  # chi2>1 -> outlier (frontend.cpp:293-307)

    # ---- coarse-round lightening (throughput knobs; 0 = inherit the full
    #      fine-round strength, the reference behavior) ----
    # The tracking step runs match -> RANSAC -> LM twice per frame: coarse
    # at the previous pose, fine at the refreshed pose (the reference's
    # double EstimatePosePnP, frontend.cpp:100-108).  The fine round always
    # re-runs the FULL search seeded by the coarse result, so the coarse
    # round only has to land inside the fine round's convergence basin -
    # fewer hypothesis lanes / LM iterations there trade nothing that the
    # fine round does not re-earn.  Accuracy under any nonzero setting used
    # for benchmarking must be re-verified (test_throughput_config_parity).
    coarse_ransac_hypotheses: int = 0
    coarse_pose_ba_iterations: int = 0

    # ---- local BA backend (src/backend.cpp:19-195) ----
    ba_iterations: int = 10  # per round; two rounds with pruning in between
    # Depth-prior edges: each observation with a measured sensor depth adds a
    # residual (depth_measured - z_camera) with information weight
    # ba_depth_weight / sigma(z)^2 where sigma(z) = ba_depth_sigma_scale*z^2
    # (the Kinect axial-noise law, Khoshelham & Elberink 2012).  This anchors
    # the metric scale that pure reprojection BA leaves as a gauge freedom
    # (the reference's g2o backend never uses the depth channel and silently
    # has this freedom too) while releasing its grip exactly where sensor
    # depth is least trustworthy.  Set False for strict reference parity.
    # With the triangulation baseline gate in place (which removed the
    # early-map corruption that made ATE chaotic in the weight), 240-frame
    # 640x480 ATE is INSENSITIVE to this weight on the clean-depth easy
    # scene (w0.1 / w0.2 / off all measure 0.26 cm, twin 0.93) and the
    # prior earns its keep exactly where depth is noisy: hard fr1-like
    # scene 0.17 cm with w0.2 vs 0.66 cm with the prior off (twin 0.76).
    ba_use_depth_prior: bool = True
    ba_depth_weight: float = 0.2
    ba_depth_sigma_scale: float = 1.4e-3
    ba_depth_sigma_floor: float = 4.0e-3
    # "Latest keyframe wins" coalescing: the reference's backend thread
    # drops keyframes that arrive while it is busy (condvar without a queue,
    # backend.cpp:8-17).  0 = optimize every keyframe; N > 0 = skip BA if
    # fewer than N frames passed since the last solve (throughput mode).
    ba_min_frame_gap: int = 0
    ba_max_poses: int = 16  # covisible-window pose capacity (padded)
    ba_max_points: int = 8192  # mappoint capacity inside one BA solve
    # bf16 for the per-edge block products inside the LM body (f32
    # accumulation and solves).  ~2x less HBM traffic per iteration; the
    # normal-equation blocks lose ~3 significand bits, well inside the
    # robustified solver's tolerance (chi2 gating and costs stay f32).
    ba_bf16: bool = True
    # BRIEF pattern-rotation quantization bins for the diff-table matmul
    # descriptor path (ops/orb.py); more bins = closer to the continuous
    # sampler at linearly more descriptor-matmul FLOPs.  240-frame synthetic
    # ATE: 90 bins 0.83 cm, 120 bins 0.73 cm (saturated - the sampler's own
    # 0.5 px offset rounding dominates beyond this), measured baseline 0.78.
    orb_angle_bins: int = 120
    # rotation-bin chunk of the BRIEF diff-table matmul: each chunk
    # materializes an [N, chunk, 256] comparison slab.  Small keeps peak
    # HBM bounded for many-stream batching; single-stream can afford
    # bigger chunks (fewer, larger matmuls)
    orb_brief_chunk: int = 6
    # bf16 operands (f32 accumulate) for the BRIEF diff-table matmul on
    # device; False forces the f32 path everywhere so the CPU-tested
    # numerics can be reproduced on TPU (parallel of ba_bf16)
    orb_bf16: bool = True
    # bf16 for the patch-canvas row-take and the one-hot column-select
    # matmul in ORB extract (f32 accumulation) - halves the HBM traffic of
    # the largest per-frame intermediate ([N, 2*PATCH, padded_width], ~88 MB
    # per 640x480 stream).  Pixel values lose <1 gray level, the same
    # magnitude as the sampler's own 0.5 px offset rounding; TPU only (the
    # CPU path stays f32 like orb_bf16).  Off until measured to win.
    orb_patch_bf16: bool = False

    # ---- descriptor matching layout ----
    # True: match straight from the packed [C, 8] uint32 descriptor pool
    # (ops/pallas_match kernel) and drop the persistent [C, 256] int8
    # bipolar pool from VOState - 8x less map memory per stream.  Measured
    # on v5e it is 0.2-0.3 ms/frame SLOWER than the dense-pool matmul
    # (see ops/matching.nearest_keypoints_packed), so the default trades
    # memory for time only when a deployment is HBM-capped.
    packed_matching: bool = False

    # ---- tracking-map / covisibility (frame.cpp:114, frontend.cpp:163-166) --
    covisibility_weight_threshold: int = 15
    tracking_map_min_points: int = 100
    max_observe_angle: float = math.pi / 6  # frame.cpp:86-89

    # ---- quality gates (frontend.cpp:334-364) ----
    max_motion_norm: float = 5.0

    # ---- relocalization (net-new: the reference stays LOST forever,
    #      frontend.cpp:146-148) ----
    # While LOST, match against the whole map without a frustum filter and
    # re-enter TRACKING when the refined pose has enough inliers.
    enable_relocalization: bool = True
    reloc_min_inliers: int = 30

    # ---- online loop closure (net-new: the reference never leaves the
    #      local BA window) ----
    # Every N keyframes (and once more at run close) the run loop relaxes
    # ALL keyframes against the loop-closure pose graph (co-observation +
    # appearance edges) and deforms the map with them - globalopt.relax_map
    # called live, which is safe mid-run (the tracking reference moves with
    # its keyframe).  A relaxation that detects NO loop edges is a no-op
    # (require_loop - loopless relaxes measurably degrade BA-refined
    # poses); after one that does act, every already-streamed pose is
    # corrected in memory and the trajectory file is re-emitted.  The
    # relaxation synchronizes the host on the current state, so it trades
    # per-frame latency for global consistency.  0 = off (default;
    # --global-relax still relaxes once offline after the run).
    relax_every_kf: int = 0
    # minimum keyframe timestamp gap (seconds) for a co-observation edge to
    # count as a loop closure (shorter-gap pairs are ordinary covisibility,
    # already optimized by local BA)
    relax_loop_gap_s: float = 5.0
    # run the online relaxation ASYNCHRONOUSLY: graph build + solve happen
    # on a worker thread over a state snapshot while tracking continues,
    # and the correction is applied at a later drain ("latest wins", like
    # the reference backend's condvar trigger - backend.h:33-37).  False
    # restores the round-4 synchronous semantics (each relaxation completes
    # in-line before the next frame - deterministic, but the first firing
    # stalls the loop on graph build + compile + solve).
    relax_async: bool = True

    # ---- localization-only mode (net-new: track against a frozen map) ----
    # The map is read-only: no keyframe inserts, no new mappoints, no
    # triangulation, no BA - the pipeline localizes against a prior map
    # (typically loaded via io/checkpoint).  Candidates come from the whole
    # alive map (the covisibility window is keyed to the reference keyframe,
    # which never advances here), still frustum-filtered per round; the
    # motion prior advances on every well-tracked frame instead of only on
    # keyframes.  Start kidnapped (fsm=LOST) to let relocalization find the
    # initial pose anywhere in the map; requires enable_relocalization.
    localization_only: bool = False

    # ---- fixed capacities of the functional map state ----
    # Sized for whole TUM fr1-class sequences: ~400 keyframes, tens of
    # thousands of live landmarks (outlier slots are recycled).
    max_keyframes: int = 512
    max_mappoints: int = 65536
    max_obs_per_mappoint: int = 16
    # past keyframe capacity: "ring" recycles the oldest slot (slot 0, the
    # gauge anchor, stays pinned) so arbitrarily long sequences keep working
    # like the reference's unbounded map (mapmanager.h:28-33); "refuse" drops
    # the insert and raises the kf_overflow flag in StepOutput
    keyframe_eviction: str = "ring"

    # ---- triangulation (util.h:16-34, frontend.cpp:465-506) ----
    triangulation_min_obs: int = 2
    triangulation_sv_ratio: float = 1e-2
    triangulation_batch: int = 1024  # mappoints triangulated per keyframe
    # Minimum camera-center span (meters) among a landmark's observers
    # before a DLT refinement may overwrite its depth-derived position.
    # The sigma-ratio gate only rejects algebraic degeneracy: two keyframes
    # 0.05 m apart at fr1 depths pass it while triangulating with
    # z^2 sigma_px/(f b) ~ 8 cm depth noise - 40x the Kinect axial noise of
    # the position being overwritten (break-even b = sigma_px/(f k) ~ 0.7 m
    # at 0.5 px).  The reference is insulated by its break-after-one quirk
    # (frontend.cpp:501); at triangulation_batch scale the unguarded
    # refinement corrupted the EARLY map, measured on the 240-frame easy
    # scene (CPU) as frames 0-40 RMSE 2.51 cm vs 0.2-0.4 cm later.
    # 0 disables the gate (and strict_parity sets 0).
    triangulation_min_baseline: float = 0.4
    # the reference `break`s after the first successful triangulation per
    # keyframe (frontend.cpp:501); set True only for strict parity runs
    compat_single_triangulation: bool = False
    # the reference increments the lost counter twice per bad frame
    # (frontend.cpp:113-114); set True for strict parity
    compat_double_lost_increment: bool = False
    # the reference writes EVERY non-LOST frame's estimated pose to the
    # trajectory, even ones that failed the quality gate (run_vo.cpp calls
    # writePosetoFile unconditionally after AddFrame); we skip untracked
    # frames by default - set True for strict parity of output files
    compat_write_untracked_poses: bool = False

    # ---- strict reference parity ----
    # One switch flipping every documented improvement back to the
    # reference's exact behavior: load the reference YAML, set this, and the
    # run matches the reference semantics without knowing the individual
    # flags.  The flipped set is listed in __post_init__.
    strict_parity: bool = False

    # ---- numerics ----
    dtype: str = "float32"

    # fields overridden (to these values) when strict_parity is set
    _PARITY_OVERRIDES = {
        "enable_relocalization": False,  # reference stays LOST (frontend.cpp:146-148)
        "ba_use_depth_prior": False,  # g2o backend never uses the depth channel
        "compat_single_triangulation": True,  # frontend.cpp:501 break
        "triangulation_min_baseline": 0.0,  # reference has no parallax gate
        "compat_double_lost_increment": True,  # frontend.cpp:113-114
        "compat_write_untracked_poses": True,  # run_vo.cpp:116 unconditional
        "keyframe_eviction": "refuse",  # reference never recycles keyframes
        "ba_min_frame_gap": 0,  # every keyframe wakes the backend
    }

    def __post_init__(self):
        if self.number_of_features <= 0:
            raise ValueError("number_of_features must be positive")
        if self.level_pyramid <= 0:
            raise ValueError("level_pyramid must be positive")
        if self.scale_factor <= 1.0:
            raise ValueError("scale_factor must be > 1")
        if self.keyframe_eviction not in ("ring", "refuse"):
            raise ValueError("keyframe_eviction must be 'ring' or 'refuse'")
        if self.strict_parity:
            for name, value in self._PARITY_OVERRIDES.items():
                object.__setattr__(self, name, value)

    # Mapping from reference YAML keys (config/default.yaml) to field names.
    _YAML_KEYS = {
        "dataset_dir": "dataset_dir",
        "output_file": "output_file",
        "camera.fx": "camera_fx",
        "camera.fy": "camera_fy",
        "camera.cx": "camera_cx",
        "camera.cy": "camera_cy",
        "camera.depth_scale": "camera_depth_scale",
        "number_of_features": "number_of_features",
        "scale_factor": "scale_factor",
        "level_pyramid": "level_pyramid",
        "match_ratio": "match_ratio",
        "max_num_lost": "max_num_lost",
        "min_inliers": "min_inliers",
        "keyframe_rotation": "keyframe_rotation",
        "keyframe_translation": "keyframe_translation",
        "enable_local_optimization": "enable_local_optimization",
        "chi2_th": "chi2_th",
        "enable_viewer": "enable_viewer",
    }

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "VOConfig":
        """Build a config from a flat dict of YAML keys.

        Both the reference's dotted keys (``camera.fx``) and the dataclass
        field names (``camera_fx``) are accepted.
        """
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        for key, value in raw.items():
            name = cls._YAML_KEYS.get(key, key)
            if name not in fields:
                continue  # ignore unknown keys like the reference FileStorage
            ftype = fields[name].type
            if ftype in ("bool", bool):
                value = bool(int(value)) if not isinstance(value, bool) else value
            elif ftype in ("int", int):
                value = int(value)
            elif ftype in ("float", float):
                value = float(value)
            kwargs[name] = value
        return cls(**kwargs)

    def replace(self, **kw) -> "VOConfig":
        return dataclasses.replace(self, **kw)


# PyYAML's YAML 1.1 resolvers for plain (unquoted) scalars
# (yaml/resolver.py), so a value types as ``yaml.safe_load`` types it
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_KEY = re.compile(r"^([^\s#'\"\[\]{}:,&*!|>%@`-][^:#]*?):(?:\s+(.*))?$")
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
    "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
    "L": " ", "P": " ",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(digits: str, cast):
    value = cast(0)
    for part in digits.split(":"):
        value = value * 60 + cast(part)
    return value


def _plain_scalar(s: str):
    """A plain scalar typed by PyYAML's rules (``SafeConstructor``)."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    return s


def _quoted_scalar(s: str, lineno: int):
    """A single- or double-quoted scalar at the start of ``s`` and the text
    after its closing quote."""
    q, out, i = s[0], [], 1
    while i < len(s):
        ch = s[i]
        if q == "'" and ch == "'":
            if s[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), s[i + 1 :]
        if q == '"' and ch == '"':
            return "".join(out), s[i + 1 :]
        if q == '"' and ch == "\\":
            esc = s[i + 1 : i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            if esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                code = s[i + 2 : i + 2 + n]
                if len(code) != n or any(c not in "0123456789abcdefABCDEF" for c in code):
                    raise ValueError(f"line {lineno}: bad escape \\{esc}{code}")
                out.append(chr(int(code, 16)))
                i += 2 + n
                continue
            raise ValueError(f"line {lineno}: unknown escape \\{esc}")
        out.append(ch)
        i += 1
    raise ValueError(f"line {lineno}: unterminated quoted scalar")


def _parse_opencv_yaml(text: str) -> dict:
    """Parse an OpenCV FileStorage YAML file (the reference's config format)
    without PyYAML, which the CUDA machines may lack.

    Reads the subset that ``cv::FileStorage`` gives the reference
    (``src/config.cpp:29``) and that the repo's configs use: the
    ``%YAML:1.0`` directive, ``---``, ``#`` comments and flat
    ``key: scalar`` lines, each scalar typed as ``yaml.safe_load`` types it
    (int, float, bool, null, quoted and plain strings).  Any other YAML
    construct raises ``ValueError``.
    """
    data: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if line.startswith("%YAML") or line.strip() == "---":
            continue
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        m = _KEY.match(line.rstrip())
        if m is None or line[0].isspace():
            raise ValueError(f"line {lineno}: not a flat 'key: scalar' line: {line!r}")
        key, rest = m.group(1).rstrip(), (m.group(2) or "")
        if rest[:1] in ("'", '"'):
            value, tail = _quoted_scalar(rest, lineno)
            tail = tail.strip()
            if tail and not tail.startswith("#"):
                raise ValueError(f"line {lineno}: text after a quoted scalar: {line!r}")
        else:
            comment = re.search(r"(?:^|\s)#", rest)
            plain = (rest[: comment.start()] if comment else rest).strip()
            if plain[:1] in tuple("[]{}&*!|>%@`,#") or plain.startswith("- ") or ": " in plain or plain.endswith(":"):
                raise ValueError(f"line {lineno}: not a flat scalar: {line!r}")
            value = _plain_scalar(plain)
        data[_plain_scalar(key)] = value
    return data


def load_config(path: str) -> VOConfig:
    """Load a VOConfig from a YAML file (reference or native format).

    Equivalent of ``Config::setParameterFile`` + typed ``Config::get``
    (``src/config.cpp:25-42``, ``include/myslam/config.h:42-46``), but the
    result is an immutable value, not a process-global singleton.
    """
    with open(path, "r", encoding="utf-8") as f:
        return VOConfig.from_dict(_parse_opencv_yaml(f.read()))
