"""What decides ``correct``: the program's timed path held to the plain reference.

The program's state chains a run's frames together, and the reference is as
slow as the program (both launch-bound in eager PyTorch), so the reference
follows the program step by step instead of re-running the sequence: at
steps drawn from the seed, the harness keeps a copy of the program's state
before the step (:class:`Sampler`), the frame, what the step produced (its
keypoints, descriptors and matches, its state after) and the record the
host read.  Once the window has closed, the reference (``vobench/reference``)
runs the same step from the same state and frame in two parts:

- ORB on the frame, against the program's keypoints and descriptors
  (``kp_off``, ``desc_bits_off``);
- the rest of the step on the program's keypoints (as a served model's
  reference reads the served tokens): matches, the two pose rounds and the
  decisions, against the program's matches, record and counters
  (``match_off``, ``pose_gap_um``, ``rot_gap_urad``, ``decisions_off``);
- the map update on the program's own tracking output (its pose, matches
  and inliers), against the program's map after the step: live slots on
  one side only (``map_off``) and the largest position gap over the rest
  (``map_gap_um``).  Held apart from the pose rounds, a new or triangulated
  point is compared to its own counterpart, whatever the rounding of the
  pose that placed it.

The same is done for a BA dispatch (:func:`compare_ba`) and, where the
program closes loops online, for a relaxation (:func:`compare_relax`): the
reference computes it again from the program's snapshot (edge counts and
keyframe deltas, ``relax_edges_off``, ``relax_kf_gap_um``,
``relax_rot_gap_urad``), applies its own to the program's state before the
apply (``relax_map_off``, ``relax_map_gap_um``) and corrects the program's
uncorrected poses with it (``relax_traj_gap_um``).  What this skips
is checked on its own: the initial state against the one the reference
builds from the seed (``init_off``), the state the program carries into the
next step against the one the step left (``carry_off``), and the host's BA
schedule against the one the records imply (``ba_schedule_off``).

Each compared number has a limit (``vobench/limits/<cell>.json``); the
exact ones (``EXACT``) have the limit 0.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

# record layout of the program's StepOutput (``frontend.py``): T_c_w 0-6,
# T_w_c 7-13, then these fields
REC = {"tracked": 14, "fsm": 15, "is_keyframe": 16, "needs_ba": 17, "num_keyframes": 25, "kf_overflow": 27}
DECISION_FIELDS = ("tracked", "fsm", "is_keyframe", "num_keyframes", "kf_overflow")
# state leaves a step sets and BA leaves alone
STATE_COUNTERS = ("num_kf", "frame_index", "fsm", "ref_kf", "lost_count", "rng")
EXACT = ("init_off", "decisions_off", "carry_off", "ba_schedule_off")


def reference_modules():
    """The reference's modules (imported here, after the window)."""
    from vobench.reference import camera, config, mapstate, random
    from vobench.reference.pipeline import backend, frontend, globalopt

    return dict(camera=camera, config=config, mapstate=mapstate, random=random, backend=backend, frontend=frontend,
                globalopt=globalopt)


@contextlib.contextmanager
def precision(mode: str):
    """``"fp32"``: float32 matmuls (TF32 off, as the program runs); ``"tf32"``:
    the control's lower precision."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = on, on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def leaves(state) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


class Sampler:
    """Copies of the program's state around the steps the check samples.

    ``rows`` are the sampled streams (``None``: an unbatched single stream,
    kept as a batch of one).  The harness arms a track sample before it
    hands in a sampled step; the wrappers of the program's two step halves
    then copy the state before, the tracking half's output, the state after
    and, at the next step, the state carried into it.  Each BA dispatch is
    logged with ``context``, the
    index of the record that asked for it; an armed BA sample copies the
    state before and after the dispatch.  Of the relaxations computed in the
    window, the first ``relax_wanted`` that act are kept with their
    snapshot, the state before and after their apply and the per-frame
    poses before and after their correction.
    """

    def __init__(self, rows):
        self.rows = rows
        self.context = None
        self.track_step = None  # the step being captured, or None
        self._carry = None  # the captured step whose successor's state is still to copy
        self.ba_armed = 0  # BA dispatches still to capture
        self._ba = None  # the BA dispatch being captured
        self.track: dict = {}
        self.ba: list = []
        self.dispatches: list = []
        self.init: dict | None = None
        self.relax_wanted = 0
        self.relax: list = []  # the kept relaxations
        self.relax_seen: list = []  # (acted, max correction m) of each computed in the window
        self._apply = None  # the kept relaxation being applied

    def take(self, x: torch.Tensor) -> torch.Tensor:
        if self.rows is None:
            return x[None].clone()
        return x.index_select(0, self.rows)

    def take_all(self, d: dict) -> dict:
        return {k: self.take(v) for k, v in d.items()}

    def before_compute(self, states) -> None:
        if self._carry is not None:
            now = leaves(states)
            self.track[self._carry]["carried"] = {n: self.take(now[n]) for n in STATE_COUNTERS}
            self._carry = None
        if self.track_step is not None:
            self.track[self.track_step] = dict(pre=self.take_all(leaves(states)))

    def on_compute(self, inter) -> None:
        if self.track_step is not None:
            self.track[self.track_step]["inter"] = self.take_all(inter._asdict())

    def on_update(self, states) -> None:
        if self.track_step is not None:
            self.track[self.track_step]["post"] = self.take_all(leaves(states))
            self._carry, self.track_step = self.track_step, None

    def before_ba(self, pre, kf, pred) -> None:
        """Called before a BA dispatch; its state after goes to :meth:`on_ba`."""
        self.dispatches.append(self.context)
        self._ba = None
        if self.ba_armed:
            self._ba = dict(pre=self.take_all(leaves(pre)), kf=self.take(kf), pred=self.take(pred))
            self.ba_armed -= 1

    def on_ba(self, post) -> None:
        if self._ba is not None:
            self._ba["post"] = self.take_all(leaves(post))
            self.ba.append(self._ba)
            self._ba = None

    def on_relax(self, snapshot, kwargs: dict, rlx, in_window: bool) -> None:
        """A relaxation computed from ``snapshot`` (the program's private
        clone of its state, kept as it is: on the worker thread nothing is
        copied) with ``compute_relaxation``'s keyword arguments."""
        if not in_window:
            return
        acted = bool(rlx.report.kf_ts.size)
        self.relax_seen.append((acted, float(rlx.report.max_correction_m)))
        if acted and len(self.relax) < self.relax_wanted:
            self.relax.append(dict(snap={n: v[None] for n, v in leaves(snapshot).items()}, kwargs=dict(kwargs), rlx=rlx))

    def before_apply(self, state, rlx) -> None:
        self._apply = next((c for c in self.relax if c["rlx"] is rlx and "pre" not in c), None)
        if self._apply is not None:
            self._apply["pre"] = self.take_all(leaves(state))

    def on_apply(self, state) -> None:
        if self._apply is not None:
            self._apply["post"] = self.take_all(leaves(state))

    def on_correct(self, report, frame_ts, poses_w_c, out) -> None:
        """The per-frame poses before and after the correction that follows
        the apply."""
        if self._apply is not None and self._apply["rlx"].report is report:
            self._apply.update(ts=np.array(frame_ts), poses=np.array(poses_w_c), corrected=np.array(out))
            self._apply = None


def expected_dispatches(needs_ba: list, gap: int) -> list:
    """The records whose read dispatches a BA under the program's rule
    (``ba_min_frame_gap``): a read record asks for one when a stream's
    ``needs_ba`` is set, and it runs when more than ``gap`` records were read
    since the last one (``VisualOdometry._materialize``,
    ``MultiStreamVO._drain_ba``)."""
    out, since = [], 1 << 30
    for j, needs in enumerate(needs_ba):
        since += 1
        if needs and since > gap:
            out.append(j)
            since = 0
    return out


def _quat_angle(a: np.ndarray, b: np.ndarray) -> float:
    """Angle (rad) between two unit quaternions (w, x, y, z), sign-free."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    w = a @ b
    xyz = a[0] * b[1:] - b[0] * a[1:] - np.cross(a[1:], b[1:])
    return float(2.0 * np.arctan2(np.linalg.norm(xyz), abs(w)))


def compare_orb(prog: dict, ref: dict) -> dict:
    """Keypoints (positions) in one side's set and not in the other's, and
    descriptor bits that differ between the two sides' keypoints at the same
    position.  Sets, not slots: the slots follow the Harris ranking, whose
    near-ties rounding may reorder."""
    def table(side):
        v = side["kp_valid"].cpu()
        xy = side["xy"].cpu()[v].tolist()
        desc = side["desc"].cpu()[v].tolist()
        return {tuple(p): d for p, d in zip(xy, desc)}

    p, r = table(prog), table(ref)
    bits = sum(bin((a ^ b) & 0xFFFFFFFF).count("1") for q in p.keys() & r.keys() for a, b in zip(p[q], r[q]))
    return dict(kp_off=len(p.keys() ^ r.keys()), desc_bits_off=bits)


def compare_track(prog: dict, ref: dict) -> dict:
    """Gaps between two outcomes of the step after ORB, on the same keypoints:
    ``prog`` (the program's or the control's) and ``ref`` (the reference's),
    each with ``inter`` (the tracking half's fields), ``post`` (state leaves
    after) and ``record`` (the ``[32]`` record)."""
    p_rec = np.asarray(prog["record"], np.float64)
    r_rec = np.asarray(ref["record"], np.float64)
    off = sum(int(p_rec[REC[f]] != r_rec[REC[f]]) for f in DECISION_FIELDS)
    off += sum(int(not torch.equal(prog["post"][n].cpu(), ref["post"][n].cpu())) for n in STATE_COUNTERS + ("kf_valid",))
    pi, ri = prog["inter"], ref["inter"]
    p_m = set(pi["midx"].cpu()[pi["mval"].cpu()].tolist())
    r_m = set(ri["midx"].cpu()[ri["mval"].cpu()].tolist())
    return dict(decisions_off=off, pose_gap_um=1e6 * float(np.linalg.norm(p_rec[11:14] - r_rec[11:14])),
                rot_gap_urad=1e6 * _quat_angle(p_rec[7:11], r_rec[7:11]), match_off=len(p_m ^ r_m))


def compare_map(prog: dict, ref: dict) -> dict:
    """Two maps after the update half of one step from the same state and
    tracking output: live map-point slots on one side only, and the largest
    position gap (µm) over the slots live on both."""
    p_alive = (prog["mp_valid"] & ~prog["mp_outlier"]).cpu()
    r_alive = (ref["mp_valid"] & ~ref["mp_outlier"]).cpu()
    gap = (prog["mp_pos"].cpu() - ref["mp_pos"].cpu()).double().norm(dim=-1)[p_alive & r_alive]
    return dict(map_off=int((p_alive != r_alive).sum()), map_gap_um=1e6 * float(gap.max()) if gap.numel() else 0.0)


def carry_off(post: dict, carried: dict) -> int:
    """Counters of the state the program carried into the next step that
    differ from the ones the step left."""
    return sum(int(not torch.equal(post[n].cpu(), carried[n].cpu())) for n in carried)


def compare_ba(prog: dict, ref: dict) -> dict:
    """Gaps between two states after one BA dispatch of one stream: the
    keyframe poses' translations and the live map points' positions, and
    the map point and keyframe flags that BA's pruning sets."""
    kf = (prog["kf_valid"] & ref["kf_valid"]).cpu()
    kf_gap = (prog["kf_pose"][..., 4:7].cpu() - ref["kf_pose"][..., 4:7].cpu()).double().norm(dim=-1)[kf]
    p_alive = (prog["mp_valid"] & ~prog["mp_outlier"]).cpu()
    r_alive = (ref["mp_valid"] & ~ref["mp_outlier"]).cpu()
    mp_gap = (prog["mp_pos"].cpu() - ref["mp_pos"].cpu()).double().norm(dim=-1)[p_alive & r_alive]
    gap = max([float(kf_gap.max()) if kf_gap.numel() else 0.0, float(mp_gap.max()) if mp_gap.numel() else 0.0])
    flags = sum(int((prog[n].cpu() != ref[n].cpu()).sum()) for n in ("mp_valid", "mp_outlier", "mp_optimized", "kf_valid"))
    return dict(ba_gap_um=1e6 * gap, ba_flags_off=flags)


def _quat_angles(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angles (rad) between unit quaternions ``[..., 4]`` (w, x, y, z), sign-free."""
    a, b = a.double(), b.double()
    w = (a * b).sum(-1)
    xyz = a[..., :1] * b[..., 1:] - b[..., :1] * a[..., 1:] - torch.linalg.cross(a[..., 1:], b[..., 1:])
    return 2.0 * torch.atan2(xyz.norm(dim=-1), w.abs())


def _max_gap(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    """Largest distance between the rows of ``a`` and ``b [..., 3]`` under ``mask``."""
    gap = (a.cpu() - b.cpu()).double().norm(dim=-1)[mask.cpu()]
    return float(gap.max()) if gap.numel() else 0.0


def compare_relax(prog, ref, kf_valid: torch.Tensor) -> dict:
    """Two relaxations computed from one snapshot (``kf_valid`` its keyframe
    slots): edge counts off (co-observation, loop, appearance) and the
    largest gaps of the keyframe deltas' translations (µm) and rotations
    (µrad)."""
    p, r = prog.report, ref.report
    edges = sum(abs(getattr(p, n) - getattr(r, n)) for n in ("num_edges", "num_loop_edges", "num_appearance_edges"))
    dp, dr = prog.delta_w.cpu(), ref.delta_w.cpu()
    rot = _quat_angles(dp[:, :4], dr[:, :4])[kf_valid.cpu()]
    return dict(relax_edges_off=edges, relax_kf_gap_um=1e6 * _max_gap(dp[:, 4:7], dr[:, 4:7], kf_valid),
                relax_rot_gap_urad=1e6 * float(rot.max()) if rot.numel() else 0.0)


MOVED = ("kf_pose", "mp_pos", "prev_pose")  # the leaves a relaxation's apply moves


def compare_relax_map(prog: dict, ref: dict) -> dict:
    """Two states after a relaxation's apply to one state: elements off in
    the leaves the apply leaves alone, and the largest gap (µm) of the
    keyframe poses' and live map points' positions and of the tracking
    prior."""
    off = sum(int((prog[n].cpu() != ref[n].cpu()).sum()) for n in prog if n not in MOVED)
    gap = max(_max_gap(prog["kf_pose"][..., 4:7], ref["kf_pose"][..., 4:7], prog["kf_valid"]),
              _max_gap(prog["mp_pos"], ref["mp_pos"], prog["mp_valid"]),
              _max_gap(prog["prev_pose"][..., 4:7], ref["prev_pose"][..., 4:7], torch.ones((), dtype=torch.bool)))
    return dict(relax_map_off=off, relax_map_gap_um=1e6 * gap)


def compare_traj(prog: np.ndarray, ref: np.ndarray) -> dict:
    """Two corrections of the same per-frame ``T_w_c`` rows: the largest
    translation gap (µm)."""
    gap = np.linalg.norm(prog[:, 4:7].astype(np.float64) - ref[:, 4:7], axis=1)
    return dict(relax_traj_gap_um=1e6 * float(gap.max(initial=0.0)))


class Reference:
    """The reference, built for one configuration on one device."""

    def __init__(self, settings: dict, device):
        self.m = reference_modules()
        self.cfg = self.m["config"].VOConfig().replace(**settings)
        self.camera = self.m["camera"].Camera.from_config(self.cfg)
        self.device = device

    def state(self, leaves_: dict, k: int):
        return self.m["mapstate"].VOState(**{n: v[k].clone() for n, v in leaves_.items()})

    def init_state(self, seed: int, stream: int, batched: bool):
        ms, rnd = self.m["mapstate"], self.m["random"]
        if not batched:
            return ms.init_state(self.cfg, seed, self.device)
        return ms.init_state(self.cfg, 0, self.device).replace(rng=rnd.fold_in(rnd.PRNGKey(seed, self.device), stream))

    def orb(self, rgb, mode: str) -> dict:
        """ORB on a frame: ``xy``, ``kp_valid``, ``desc``."""
        fr, c = self.m["frontend"], self.cfg
        with precision(mode), torch.no_grad():
            f = fr.orb.extract(fr.im.rgb_to_gray(rgb), nfeatures=c.number_of_features, nlevels=c.level_pyramid,
                               scale=c.scale_factor, threshold=float(c.fast_threshold), border=c.edge_threshold,
                               angle_bins=c.orb_angle_bins)
        return dict(xy=f.xy, kp_valid=f.valid, desc=f.desc)

    def track(self, pre, rgb, depth, ts, mode: str, kp: dict | None = None) -> dict:
        """The step from ``pre`` on a frame; with ``kp`` (``xy``,
        ``kp_valid``, ``desc``) on those keypoints in place of its ORB."""
        fr = self.m["frontend"]
        extract = fr.orb.extract
        if kp is not None:
            fr.orb.extract = lambda *a, **k: _Features(kp["xy"], kp["desc"], kp["kp_valid"])
        try:
            with precision(mode), torch.no_grad():
                it = fr.track_compute(self.cfg, self.camera, pre, fr.FrameInput(rgb=rgb, depth=depth, timestamp=ts))
                post, out = fr.apply_updates(self.cfg, self.camera, pre, it)
        finally:
            fr.orb.extract = extract
        return dict(inter=it._asdict(), post=leaves(post), record=out.packed.double().cpu().numpy())

    def update(self, pre, inter: dict, mode: str) -> dict:
        """The update half from ``pre`` on a tracking output ``inter``
        (the program's): the state leaves after it."""
        fr = self.m["frontend"]
        it = fr.TrackInter(**{n: inter[n] for n in fr.TrackInter._fields})
        with precision(mode), torch.no_grad():
            post, _ = fr.apply_updates(self.cfg, self.camera, pre, it)
        return leaves(post)

    def ba(self, pre, kf_slot: int, mode: str) -> dict:
        with precision(mode), torch.no_grad():
            post, _ = self.m["backend"].ba_step(self.cfg, self.camera, pre, kf_slot)
        return leaves(post)

    def relax(self, snap, kwargs: dict, mode: str):
        """A relaxation computed from a state (``compute_relaxation``)."""
        with precision(mode), torch.no_grad():
            return self.m["globalopt"].compute_relaxation(snap, self.cfg, **kwargs)

    def apply(self, pre, rlx, mode: str) -> dict:
        with precision(mode), torch.no_grad():
            return leaves(self.m["globalopt"].apply_relaxation(pre, rlx))

    def correct(self, report, frame_ts, poses_w_c) -> np.ndarray:
        return self.m["globalopt"].correct_trajectory(report, frame_ts, poses_w_c)


class _Features:
    def __init__(self, xy, desc, valid):
        self.xy, self.desc, self.valid = xy, desc, valid


def _worst(into: dict, nums: dict) -> None:
    for k, v in nums.items():
        into[k] = max(into.get(k, v), v)


def _judge(ref: Reference, pre: dict, k: int, frame, prog: dict, nums: dict) -> None:
    """One sampled step of one stream: ``prog`` holds its ``inter``,
    ``post`` and ``record``."""
    rgb, depth, ts = frame
    kp = {n: prog["inter"][n] for n in ("xy", "kp_valid", "desc")}
    _worst(nums, compare_orb(kp, ref.orb(rgb, "fp32")))
    got = compare_track(prog, ref.track(ref.state(pre, k), rgb, depth, ts, "fp32", kp=kp))
    nums["decisions_off"] = nums.get("decisions_off", 0) + got.pop("decisions_off")
    _worst(nums, got)
    _worst(nums, compare_map(prog["post"], ref.update(ref.state(pre, k), prog["inter"], "fp32")))


def _relax_outcome(ref: Reference, cap: dict, mode: str):
    """One sampled relaxation worked out again by the reference: computed from
    the program's snapshot, applied to the program's state before its apply,
    and correcting the program's uncorrected poses (None where the program
    had none to correct)."""
    rlx = ref.relax(ref.state(cap["snap"], 0), cap["kwargs"], mode)
    post = ref.apply(ref.state(cap["pre"], 0), rlx, mode)
    traj = ref.correct(rlx.report, cap["ts"], cap["poses"]) if "corrected" in cap else None
    return rlx, post, traj


def evaluate(ref: Reference, sampler: Sampler, frames: dict, streams: list, seed: int, batched: bool,
             records: list, decided: int, gap: int, control: bool = False) -> dict:
    """The compared numbers of a run, the worst over its samples; ``decided``
    is the number of records whose BA decision the program has taken.  With
    ``control``, also the control's (the reference in TF32 put in the
    program's place, on the same states and frames) under ``"control"``."""
    nums = {"init_off": 0, "decisions_off": 0, "carry_off": 0}
    ctl: dict = {"decisions_off": 0}
    for k, s in enumerate(streams):
        want = leaves(ref.init_state(seed, s, batched))
        nums["init_off"] += sum(int(not torch.equal(sampler.init[n][k], want[n])) for n in want)
    n_track = 0
    for step, cap in sorted(sampler.track.items()):
        if "post" not in cap or step >= len(records):
            continue
        for k in range(len(streams)):
            frame = tuple(x[k] for x in frames[step][:2]) + (frames[step][2],)
            # the record as the step produced it where the entry kept it (a
            # relaxation may have corrected the one the host read since)
            record = cap["record"].double().cpu().numpy() if "record" in cap else records[step][streams[k]]
            prog = dict(inter={n: v[k] for n, v in cap["inter"].items()}, post={n: v[k] for n, v in cap["post"].items()},
                        record=record)
            _judge(ref, cap["pre"], k, frame, prog, nums)
            if "carried" in cap:
                nums["carry_off"] += carry_off(prog["post"], {n: v[k] for n, v in cap["carried"].items()})
            n_track += 1
            if control:
                c = ref.track(ref.state(cap["pre"], k), *frame, "tf32")
                _judge(ref, cap["pre"], k, frame, c, ctl)
    n_ba = 0
    for cap in sampler.ba:
        for k in range(len(streams)):
            pre = ref.state(cap["pre"], k)
            asked = bool(cap["pred"][k])
            r = ref.ba(pre, int(cap["kf"][k]), "fp32") if asked else leaves(pre)
            _worst(nums, compare_ba({n: v[k] for n, v in cap["post"].items()}, r))
            # what the reference's BA changed: what a BA left out would read
            moved = compare_ba({n: v[k] for n, v in cap["pre"].items()}, r)
            _worst(nums, {"ba_moved_um": moved["ba_gap_um"], "ba_moved_flags": moved["ba_flags_off"]})
            n_ba += 1
            if control and asked:
                _worst(ctl, compare_ba(ref.ba(ref.state(cap["pre"], k), int(cap["kf"][k]), "tf32"), r))
    n_relax = 0
    for cap in sampler.relax:
        if "post" not in cap:
            continue
        kf_valid = cap["snap"]["kf_valid"][0]
        r, r_post, r_traj = _relax_outcome(ref, cap, "fp32")
        _worst(nums, compare_relax(cap["rlx"], r, kf_valid))
        _worst(nums, compare_relax_map({n: v[0] for n, v in cap["post"].items()}, r_post))
        if r_traj is not None:
            _worst(nums, compare_traj(cap["corrected"], r_traj))
        n_relax += 1
        if control:
            c, c_post, c_traj = _relax_outcome(ref, cap, "tf32")
            _worst(ctl, compare_relax(c, r, kf_valid))
            _worst(ctl, compare_relax_map(c_post, r_post))
            if r_traj is not None:
                _worst(ctl, compare_traj(c_traj, r_traj))
    if sampler.relax_seen:
        nums["relax_computed"] = len(sampler.relax_seen)
        nums["relax_acted"] = sum(a for a, _ in sampler.relax_seen)
        nums["relax_max_correction_um"] = 1e6 * max(c for _, c in sampler.relax_seen)
    needs = [bool(np.any(rec[:, REC["needs_ba"]] > 0.5)) for rec in records[:decided]]
    want = set(expected_dispatches(needs, gap))
    seen = {d for d in sampler.dispatches if d is not None}
    nums["ba_schedule_off"] = len(want ^ seen)
    out = dict(numbers=nums, track_samples=n_track, ba_samples=n_ba, relax_samples=n_relax)
    if control:
        out["control"] = ctl
    return out


def verdict(numbers: dict, limits: dict, need_ba: bool, track_samples: int, ba_samples: int,
            relax_samples: int | None = None) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit.  A number the
    run has no sample for, or a missing sample kind, makes it not correct:
    ``relax_samples`` (not None where the cell relaxes) counts the sampled
    relaxations that acted."""
    shown, ok = {}, track_samples > 0 and (ba_samples > 0 or not need_ba)
    for name in EXACT:
        v = numbers.get(name)
        shown[name] = {"value": v, "limit": 0}
        ok = ok and v == 0
    for name, lim in limits.items():
        v = numbers.get(name)
        shown[name] = {"value": v, "limit": lim}
        ok = ok and v is not None and v <= lim
    shown["samples"] = {"value": track_samples, "limit": 1}
    if need_ba:
        shown["ba_samples"] = {"value": ba_samples, "limit": 1}
    if relax_samples is not None:
        shown["relax_samples"] = {"value": relax_samples, "limit": 1}
        ok = ok and relax_samples > 0
    return bool(ok), shown
