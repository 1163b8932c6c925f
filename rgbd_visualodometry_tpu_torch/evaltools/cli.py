"""Evaluation command line - the ``tools/evaluate_*.py`` entry points.

The port's own copy of ``rgbd_visualodometry_tpu/evaltools/cli.py``, held
equal to it by ``tests/test_torch_evaltools.py`` (the same printed lines
and byte-equal ``--save`` files); installed as ``rgbd-vo-torch-eval``.

Usage (mirrors the reference tools' argument order):

    python -m rgbd_visualodometry_tpu_torch.evaltools.cli ate GROUNDTRUTH EST
    python -m rgbd_visualodometry_tpu_torch.evaltools.cli rpe GROUNDTRUTH EST --delta 1.0
    python -m rgbd_visualodometry_tpu_torch.evaltools.cli associate RGB_TXT DEPTH_TXT
    python -m rgbd_visualodometry_tpu_torch.evaltools.cli plot RGB_TXT TRAJ --out-dir DIR
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _plot_ate(res, path: str) -> None:
    """Top-down (x/y) trajectory comparison png - the reference's --plot
    output (``evaluate_ate.py:164-180``): ground truth black, aligned
    estimate blue, red segments joining associated pose pairs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    g, e = res.gt_matched, res.est_aligned
    ax.plot(g[:, 0], g[:, 1], "-", color="black", label="ground truth")
    ax.plot(e[:, 0], e[:, 1], "-", color="blue", label="estimated")
    for gp, ep in zip(g[:: max(1, len(g) // 200)], e[:: max(1, len(e) // 200)]):
        ax.plot([gp[0], ep[0]], [gp[1], ep[1]], "-", color="red", linewidth=0.5)
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(path, dpi=90)
    plt.close(fig)


def _plot_rpe(res, path: str) -> None:
    """Translational error over time png - the reference's --plot output
    (``evaluate_rpe.py:349-360``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    stamps = res.pair_stamps[:, 0] - res.pair_stamps[0, 0]
    ax.plot(stamps, res.trans_errors, "-", color="blue")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("translational error [m]")
    fig.savefig(path, dpi=90)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rgbd-vo-torch-eval", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("ate", help="absolute trajectory error (Horn alignment)")
    a.add_argument("groundtruth")
    a.add_argument("estimate")
    a.add_argument("--max_difference", type=float, default=0.02)
    a.add_argument("--offset", type=float, default=0.0)
    a.add_argument("--scale", type=float, default=1.0)
    a.add_argument(
        "--save", help="save aligned estimate to disk (format: stamp2 x2 y2 z2)"
    )
    a.add_argument(
        "--save_associations",
        help="save associated gt + aligned estimate "
        "(format: stamp1 x1 y1 z1 stamp2 x2 y2 z2)",
    )
    a.add_argument(
        "--plot", help="plot ground truth and aligned estimate to a png"
    )
    a.add_argument("--verbose", action="store_true")

    # full evaluate_rpe.py flag set (tools/evaluate_rpe.py:315-345)
    r = sub.add_parser("rpe", help="relative pose error")
    r.add_argument("groundtruth")
    r.add_argument("estimate")
    r.add_argument("--delta", type=float, default=1.0)
    r.add_argument(
        "--delta_unit", choices=("s", "m", "rad", "deg", "f"), default="s"
    )
    r.add_argument(
        "--fixed_delta", action="store_true",
        help="only consider pose pairs that have a distance of delta "
        "(default like the reference: random pair sampling)",
    )
    r.add_argument("--max_pairs", type=int, default=10000)
    r.add_argument("--offset", type=float, default=0.0)
    r.add_argument("--scale", type=float, default=1.0)
    r.add_argument(
        "--save",
        help="save per-pair errors (format: stamp_est0 stamp_est1 stamp_gt0 "
        "stamp_gt1 trans_error rot_error)",
    )
    r.add_argument(
        "--plot", help="plot translational error over time to a png "
        "(requires --fixed_delta)"
    )
    r.add_argument("--verbose", action="store_true")

    s = sub.add_parser("associate", help="timestamp association")
    s.add_argument("first_file")
    s.add_argument("second_file")
    s.add_argument(
        "--first_only", action="store_true",
        help="only output associated lines from first file",
    )
    s.add_argument("--offset", type=float, default=0.0)
    s.add_argument("--max_difference", type=float, default=0.02)

    # tools/plot_trajectory_into_image.py twin: project every past camera
    # pose into each frame as RGB axes (its hard-coded Kinect intrinsics
    # 525 / 319.5 / 239.5 stay the defaults)
    p = sub.add_parser("plot", help="draw the trajectory's camera axes into the image sequence")
    p.add_argument("image_list", help="TUM rgb.txt (stamp path per line)")
    p.add_argument("trajectory_file", help="TUM trajectory (stamp tx ty tz qx qy qz qw)")
    p.add_argument("--out-dir", default="plot_out")
    p.add_argument("--fx", type=float, default=525.0)
    p.add_argument("--fy", type=float, default=525.0)
    p.add_argument("--cx", type=float, default=319.5)
    p.add_argument("--cy", type=float, default=239.5)

    args = ap.parse_args(argv)

    from rgbd_visualodometry_tpu_torch.io.trajectory import read_trajectory
    from rgbd_visualodometry_tpu_torch.io.tum import associate, read_file_list

    if args.cmd == "ate":
        from rgbd_visualodometry_tpu_torch.evaltools import absolute_trajectory_error

        gt_ts, gt = read_trajectory(args.groundtruth)
        est_ts, est = read_trajectory(args.estimate)
        res = absolute_trajectory_error(
            est_ts, est[:, 4:7], gt_ts, gt[:, 4:7],
            max_difference=args.max_difference, offset=args.offset,
            scale=args.scale,
        )
        if args.save:
            with open(args.save, "w") as f:
                for ts, p in zip(res.est_stamps, res.est_aligned):
                    f.write(f"{ts:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if args.save_associations:
            with open(args.save_associations, "w") as f:
                for ts1, g, ts2, p in zip(
                    res.gt_stamps, res.gt_matched, res.est_stamps, res.est_aligned
                ):
                    f.write(
                        f"{ts1:.6f} {g[0]:.6f} {g[1]:.6f} {g[2]:.6f} "
                        f"{ts2:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n"
                    )
        if args.plot:
            _plot_ate(res, args.plot)
        if args.verbose:
            print(f"compared_pose_pairs {res.num_pairs} pairs")
            print(f"absolute_translational_error.rmse {res.rmse:.6f} m")
            print(f"absolute_translational_error.mean {res.mean:.6f} m")
            print(f"absolute_translational_error.median {res.median:.6f} m")
            print(f"absolute_translational_error.std {res.std:.6f} m")
            print(f"absolute_translational_error.min {res.min:.6f} m")
            print(f"absolute_translational_error.max {res.max:.6f} m")
        else:
            print(f"{res.rmse:.6f}")
    elif args.cmd == "rpe":
        from rgbd_visualodometry_tpu_torch.evaltools import relative_pose_error

        gt_ts, gt = read_trajectory(args.groundtruth)
        est_ts, est = read_trajectory(args.estimate)
        if args.plot and not args.fixed_delta:
            ap.error("--plot requires --fixed_delta")
        res = relative_pose_error(
            est_ts, est, gt_ts, gt,
            delta=args.delta, delta_unit=args.delta_unit,
            fixed_delta=args.fixed_delta, max_pairs=args.max_pairs,
            offset=args.offset, scale=args.scale,
        )
        if args.save:
            with open(args.save, "w") as f:
                for s, te, re_ in zip(
                    res.pair_stamps, res.trans_errors, res.rot_errors
                ):
                    f.write(
                        f"{s[0]:.6f} {s[1]:.6f} {s[2]:.6f} {s[3]:.6f} "
                        f"{te:.6f} {re_:.6f}\n"
                    )
        if args.plot:
            _plot_rpe(res, args.plot)
        if not args.verbose:
            # reference prints only the mean translational error
            # (evaluate_rpe.py:368)
            print(f"{res.trans_mean:.6f}")
            return 0
        # same stat block as evaluate_rpe.py:361-380
        print(f"compared_pose_pairs {res.num_pairs} pairs")
        print(f"translational_error.rmse {res.trans_rmse:.6f} m")
        print(f"translational_error.mean {res.trans_mean:.6f} m")
        print(f"translational_error.median {res.trans_median:.6f} m")
        print(f"translational_error.std {res.trans_std:.6f} m")
        print(f"translational_error.min {res.trans_min:.6f} m")
        print(f"translational_error.max {res.trans_max:.6f} m")
        print(f"rotational_error.rmse {np.degrees(res.rot_rmse):.6f} deg")
        print(f"rotational_error.mean {np.degrees(res.rot_mean):.6f} deg")
        print(f"rotational_error.median {np.degrees(res.rot_median):.6f} deg")
        print(f"rotational_error.std {np.degrees(res.rot_std):.6f} deg")
        print(f"rotational_error.min {np.degrees(res.rot_min):.6f} deg")
        print(f"rotational_error.max {np.degrees(res.rot_max):.6f} deg")
    elif args.cmd == "associate":
        first = read_file_list(args.first_file)
        second = read_file_list(args.second_file)
        ft, st = sorted(first), sorted(second)
        for i, j in associate(ft, st, args.offset, args.max_difference):
            if args.first_only:
                print(f"{ft[i]:.6f} {' '.join(first[ft[i]])}")
            else:
                # the reference prints the second stamp minus the offset
                # (associate.py:125)
                print(
                    f"{ft[i]:.6f} {' '.join(first[ft[i]])} "
                    f"{st[j] - args.offset:.6f} {' '.join(second[st[j]])}"
                )
    elif args.cmd == "plot":
        import os

        from PIL import Image

        from rgbd_visualodometry_tpu_torch.evaltools.plot_trajectory import (
            plot_trajectory_sequence,
        )

        image_list = read_file_list(args.image_list)
        folder = os.path.dirname(os.path.abspath(args.image_list))
        traj_ts, traj = read_trajectory(args.trajectory_file)

        def frame_iter():
            for ts in sorted(image_list):
                path = os.path.join(folder, image_list[ts][0])
                yield ts, np.asarray(Image.open(path).convert("RGB"))

        written = plot_trajectory_sequence(
            traj_ts, traj, frame_iter(), args.out_dir,
            args.fx, args.fy, args.cx, args.cy,
        )
        print(f"{len(written)} images written to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
