"""Command-line driver - the ``run_vo`` equivalent, on the CUDA device.

The port's counterpart of ``rgbd_visualodometry_tpu/cli.py``: the same
flags, printed lines and exit code.  It runs on the card unless ``--cpu``
is given, and raises without a card otherwise.  Where matplotlib does not
import, an ``enable_viewer`` run renders no map PNG and says so in place of
the "map rendered to" line; its overlays and ``map.html`` are written.

Reference contract (``app/run_vo.cpp:27-134``): ``run_vo <parameter_file>``
reads the YAML config, loads the TUM dataset named by ``dataset_dir``,
tracks every frame printing per-frame timing, writes the TUM-format
trajectory to ``output_file`` and stops if tracking is lost.

Extras over the reference:

- ``--synthetic N`` runs on a generated RGB-D sequence (no dataset needed)
  and reports ATE against the exact ground truth.
- ``--evaluate GT.txt`` runs the built-in ATE/RPE evaluators afterwards
  (replacing the tools/run_ate.sh + evaluate_ate.py round trip).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rgbd-vo-torch", description=__doc__)
    ap.add_argument("config", nargs="?", help="parameter YAML file (reference format)")
    ap.add_argument("--dataset", help="override dataset_dir")
    ap.add_argument("--output", help="override output_file")
    ap.add_argument("--synthetic", type=int, metavar="N", help="run on N synthetic frames")
    ap.add_argument("--evaluate", metavar="GT", help="groundtruth.txt for ATE/RPE after the run")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--no-backend", action="store_true", help="disable local BA")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    ap.add_argument("--save-map", metavar="NPZ", help="checkpoint the final map state")
    ap.add_argument("--load-map", metavar="NPZ", help="resume from a map checkpoint")
    ap.add_argument(
        "--localize-only", action="store_true",
        help="track against the loaded map without modifying it; starts "
        "kidnapped (LOST) so relocalization finds the initial pose anywhere "
        "in the map - use with --load-map (net-new vs the reference)",
    )
    ap.add_argument("--stats", metavar="JSONL", help="write per-frame stats records")
    ap.add_argument(
        "--global-relax", action="store_true",
        help="after the run, relax all keyframes against the loop-closure "
        "pose graph and rewrite the trajectory (net-new vs the reference)",
    )
    args = ap.parse_args(argv)

    from rgbd_visualodometry_tpu_torch.config import VOConfig, load_config
    from rgbd_visualodometry_tpu_torch.pipeline.system import VisualOdometry

    cfg = load_config(args.config) if args.config else VOConfig()
    if args.dataset:
        cfg = cfg.replace(dataset_dir=args.dataset)
    if args.output:
        cfg = cfg.replace(output_file=args.output)
    if args.no_backend:
        cfg = cfg.replace(enable_local_optimization=False)
    if args.localize_only:
        cfg = cfg.replace(localization_only=True)

    gt = None
    if args.synthetic:
        from rgbd_visualodometry_tpu_torch.io.synthetic import SyntheticScene, generate_sequence

        scene = SyntheticScene(
            width=cfg.image_width, height=cfg.image_height,
            fx=cfg.camera_fx, fy=cfg.camera_fy, cx=cfg.camera_cx, cy=cfg.camera_cy,
            depth_scale=cfg.camera_depth_scale,
        )
        seq = generate_sequence(args.synthetic, scene=scene)
        frames = ((f.rgb, f.depth, f.timestamp) for f in seq)
        gt = seq
    else:
        if not cfg.dataset_dir:
            ap.error("no dataset_dir in config and no --synthetic given")
        from rgbd_visualodometry_tpu_torch.io.tum import iter_dataset

        frames = (
            (rgb, depth, rec.timestamp)
            for rec, rgb, depth in iter_dataset(
                cfg.dataset_dir, width=cfg.image_width, height=cfg.image_height
            )
        )

    if args.max_frames:
        import itertools

        frames = itertools.islice(frames, args.max_frames)

    vo = VisualOdometry(cfg, device="cpu" if args.cpu else "cuda")
    if args.load_map:
        from rgbd_visualodometry_tpu_torch.io.checkpoint import load_state

        state, _, meta = load_state(args.load_map, with_meta=True, device=vo.device)
        if args.localize_only:
            # kidnapped start: discard the checkpoint's tracking bookkeeping
            # and let whole-map relocalization find the pose from scratch
            import torch

            from rgbd_visualodometry_tpu_torch.mapstate import LOST as LOST_CODE
            from rgbd_visualodometry_tpu_torch.ops import se3

            state = state.replace(
                fsm=torch.full_like(state.fsm, LOST_CODE),
                lost_count=torch.zeros_like(state.lost_count),
                prev_pose=se3.identity(torch.float32, vo.device),
            )
        vo.state = state
        if meta.get("time_base") is not None and not args.localize_only:
            vo.time_base = float(meta["time_base"])
    t0 = time.perf_counter()
    results = vo.run(
        frames, trajectory_path=cfg.output_file, verbose=not args.quiet,
        stats_path=args.stats,
    )
    wall = time.perf_counter() - t0
    if args.global_relax:
        from rgbd_visualodometry_tpu_torch.io.trajectory import TrajectoryWriter
        from rgbd_visualodometry_tpu_torch.mapstate import LOST
        from rgbd_visualodometry_tpu_torch.pipeline import globalopt

        report = vo.global_relax()
        # re-export the 3D HTML map with the relaxed poses + loop edges
        vo.export_map_html(edges=report.loop_pairs_w)
        # rewrite with the same frame set run() streamed out
        keep = [
            r for r in results
            if (r.tracked or cfg.compat_write_untracked_poses) and r.fsm != LOST
        ]
        if report.kf_ts.size and keep:
            offs = np.asarray([r.timestamp for r in keep]) - float(vo.time_base)
            poses = globalopt.correct_trajectory(
                report, offs, np.asarray([r.pose_w_c for r in keep])
            )
            with TrajectoryWriter(cfg.output_file) as w:
                for r, p in zip(keep, poses):
                    w.write(r.timestamp, p)
        print(
            f"global relax: {report.num_edges} co-obs edges "
            f"({report.num_loop_edges} loop, {report.num_chain_edges} chain, "
            f"{report.num_appearance_edges} appearance), "
            f"keyframe correction mean|max "
            f"{report.mean_correction_m * 100:.2f}|{report.max_correction_m * 100:.2f} cm"
        )
    if args.save_map:
        from rgbd_visualodometry_tpu_torch.io.checkpoint import save_state

        save_state(vo.state, cfg, args.save_map, meta={"time_base": vo.time_base})
        print(f"map checkpoint written to {args.save_map}")

    if cfg.enable_viewer:
        # host-side viewer (the reference's enable_viewer flag,
        # run_vo.cpp:76-80): render the final map + trajectory, where
        # matplotlib imports
        from rgbd_visualodometry_tpu_torch.viz import MapViewer

        viewer = MapViewer("viewer_out")
        if viewer.can_render_map:
            traj = np.asarray([r.pose_w_c[4:7] for r in results if r.tracked])
            print(f"map rendered to {viewer.render_map(vo.map_snapshot(), trajectory=traj)}")
        else:
            print("map not rendered: matplotlib does not import here")

    tracked = sum(r.tracked for r in results)
    print(f"\n{tracked}/{len(results)} frames tracked in {wall:.1f} s "
          f"({len(results) / wall:.1f} FPS incl. compile)")
    print(f"trajectory written to {cfg.output_file}")

    if gt is not None:
        from rgbd_visualodometry_tpu_torch.evaltools import absolute_trajectory_error
        from rgbd_visualodometry_tpu_torch.io.synthetic import _pose_inverse

        est_ts = np.asarray([r.timestamp for r in results if r.tracked])
        est_xyz = np.asarray([r.pose_w_c[4:7] for r in results if r.tracked])
        gt_ts = np.asarray([f.timestamp for f in gt])
        # ground truth is T_c_w; camera position = translation of inverse
        gt_xyz = np.asarray([_pose_inverse(f.T_c_w)[4:7] for f in gt])
        ate = absolute_trajectory_error(est_ts, est_xyz, gt_ts, gt_xyz)
        print(f"ATE vs exact ground truth: rmse={ate.rmse * 100:.2f} cm over {ate.num_pairs} poses")

    if args.evaluate:
        from rgbd_visualodometry_tpu_torch.evaltools import absolute_trajectory_error, relative_pose_error
        from rgbd_visualodometry_tpu_torch.io.trajectory import read_trajectory

        est_ts, est_poses = read_trajectory(cfg.output_file)
        gt_ts, gt_poses = read_trajectory(args.evaluate)
        ate = absolute_trajectory_error(est_ts, est_poses[:, 4:7], gt_ts, gt_poses[:, 4:7])
        print(f"ATE rmse: {ate.rmse:.4f} m (mean {ate.mean:.4f}, median {ate.median:.4f}, n={ate.num_pairs})")
        try:
            rpe = relative_pose_error(est_ts, est_poses, gt_ts, gt_poses, delta=1.0)
            print(f"RPE(1s): trans rmse {rpe.trans_rmse:.4f} m, rot rmse {np.degrees(rpe.rot_rmse):.3f} deg (n={rpe.num_pairs})")
        except ValueError as e:
            print(f"RPE(1s): not computable ({e})")

    return 0 if (results and not vo.lost) else 1


if __name__ == "__main__":
    sys.exit(main())
