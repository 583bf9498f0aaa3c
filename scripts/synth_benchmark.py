#!/usr/bin/env python
"""End-to-end recognition-quality benchmark on a synthetic sequence.

Generates a trajectory with genuine revisits through a structured world,
replays it through the full pipeline (descriptor -> fused query -> evaluator),
writes the outcome file and scores it with the pr_mpe metric of record
(max-F1, recall@P=1, TP pose error) — the same protocol the reference uses on
KITTI. With no KITTI scans available in this environment, this is the
recognition-quality regression anchor; the data plane accepts real KITTI/
MulRan via the same two-file format (see utils/io.gen_kitti_dataset).

Usage: python scripts/synth_benchmark.py [out_dir] [--scans N] [--seed S]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")


def aliasing_trajectory(cells, n_scans: int, rng) -> list:
    """Visit every grid cell, then revisit them all — each revisit must be
    matched to the RIGHT aliased cell."""
    per_cell = max(2, n_scans // (2 * len(cells)))
    poses = []
    for lap in range(2):
        for (cx, cy) in cells:
            for k in range(per_cell):
                poses.append((cx + 4.0 * k - 2.0 * per_cell
                              + rng.uniform(-0.4, 0.4) + 0.8 * lap,
                              cy + rng.uniform(-0.4, 0.4),
                              rng.uniform(-0.1, 0.1) + 0.3 * lap))
            if len(poses) >= (lap + 1) * n_scans // 2:
                break
    return poses[:n_scans]


def naive_key_outcome(db, f_out: str, excl_frames: int) -> None:
    """The ablation baseline: nearest retrieval key
    wins, no cascade, no GMM — score = 1/(1+min key distance^2). On worlds
    with repeated structure this matcher confuses aliased places; the gap to
    the full pipeline's curve measures what the cascade earns."""
    import jax

    keys = np.asarray(jax.device_get(db.store.keys))[: db.n]
    lv = list(db.cfg.db.q_levels)
    K = keys[:, lv].reshape(db.n, -1, keys.shape[-1]).astype(np.float64)
    valid = np.abs(K).sum(-1) > 0                      # (N, QA)
    lines = []
    for i in range(excl_frames + 1, db.n):
        cand = K[: i - excl_frames]
        cv = valid[: i - excl_frames]
        if not cv.any() or not valid[i].any():
            continue
        d2 = ((K[i][None, :, None, :] - cand[:, None, :, :]) ** 2).sum(-1)
        d2 = np.where(cv[:, None, :] & valid[i][None, :, None], d2, np.inf)
        d2s = d2.reshape(len(cand), -1).min(-1)
        j = int(np.argmin(d2s))
        lines.append("0\t%d-%d\t%f\t0 0 0" % (i, j, 1.0 / (1.0 + d2s[j])))
    open(f_out, "w").write("\n".join(lines))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default="results/synth_bench")
    ap.add_argument("--scans", type=int, default=180)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-points", type=int, default=65536)
    ap.add_argument("--block", type=int, default=0,
                    help="replay in blocks of B scans (throughput mode)")
    ap.add_argument("--chain", type=int, default=0,
                    help="replay K scans per dispatch via step_chain_async "
                         "(exact per-scan semantics at any ts spacing)")
    ap.add_argument("--dynamic-thres", action="store_true",
                    help="enable the reference's DYNAMIC_THRES compile "
                         "flag behavior (rising lower bounds)")
    ap.add_argument("--mulran", action="store_true",
                    help="MulRan operating point (taller structures, "
                         "lv_grads (1,2.5,...,8.5), ta_h_bar 0.75)")
    ap.add_argument("--world", choices=("boxes", "occluded", "aliasing"),
                    default="boxes",
                    help="boxes: the r1 sample-everything world; occluded: "
                         "2-D raycast LiDAR model (occlusion + ring-geometry "
                         "density falloff); aliasing: grid of identical "
                         "motifs — key-only matching fails, the cascade "
                         "must disambiguate")
    ap.add_argument("--dynamic", type=int, default=0, metavar="N",
                    help="N transient clutter boxes per scan (occluded/"
                         "aliasing worlds; re-sampled every scan)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="fraction of returns dropped (occluded renderer)")
    ap.add_argument("--also-naive", action="store_true",
                    help="also score the key-only nearest-neighbor baseline "
                         "(no cascade/GMM) for comparison")
    ap.add_argument("--plot", help="save overlaid PR curves to this path")
    args = ap.parse_args()

    from synth import (build_trajectory, make_aliasing_world, make_world,
                       render_scan, render_scan_lidar, write_synth_dataset)

    from contour_context_tpu.config import ContourManagerConfig, PipelineConfig
    from contour_context_tpu.eval.pr_mpe import score_outcome

    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    if args.world == "aliasing":
        world, cells = make_aliasing_world(args.seed)
        poses = aliasing_trajectory(cells, args.scans, rng)
    else:
        world = make_world(args.seed, n_structs=260, extent=180.0)
        poses = build_trajectory(args.scans, rng)
    if args.mulran:
        world[:, 4] *= 2.2   # taller structures to exercise the MulRan ladder

    if args.world == "boxes":
        def render(w, p, seed):
            return render_scan(w, p, seed=seed)
    else:
        def render(w, p, seed):
            return render_scan_lidar(w, p, seed=seed, n_dynamic=args.dynamic,
                                     dropout=args.dropout)

    f_pose, f_lid = write_synth_dataset(args.out_dir, world, poses, rng,
                                        render=render)

    import dataclasses

    if args.mulran:
        from contour_context_tpu.config import mulran_pipeline_config
        base = mulran_pipeline_config()
        cfg = dataclasses.replace(
            base, cm=dataclasses.replace(base.cm, max_points=args.max_points))
    else:
        cfg = PipelineConfig(cm=ContourManagerConfig(max_points=args.max_points))
    if args.dynamic_thres:
        cfg = dataclasses.replace(
            cfg, db=dataclasses.replace(cfg.db, dynamic_thres=True))
    f_outcome = os.path.join(args.out_dir, "outcome-synth.txt")

    from contour_context_tpu.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu.pipeline import LoopClosurePipeline

    import jax

    ev = ContLCDEvaluator(f_pose, f_lid, cfg.correlation_thres)
    pipe = LoopClosurePipeline(cfg, ev, capacity=len(ev) + 8)
    t_all = time.perf_counter()
    if args.chain and args.block:
        ap.error("--chain and --block are mutually exclusive")
    if args.chain:
        n_warm = min(2 * args.chain, args.scans // 2)
        n_warm = args.scans - ((args.scans - n_warm) // args.chain) * args.chain
        if args.scans - n_warm < args.chain:
            ap.error("--scans %d too small for --chain %d"
                     % (args.scans, args.chain))
        pipe.run_chained(chain=args.chain, max_scans=n_warm,
                         drain_at_end=False)
        jax.block_until_ready(pipe.db.store)
        t0 = time.perf_counter()
        pipe.run_chained(chain=args.chain, drain_at_end=False)
        jax.block_until_ready(pipe.db.store)
        if pipe._pending:
            h_last = pipe._pending[-1][1]
            jax.block_until_ready(h_last.recs if hasattr(h_last, "recs")
                                  else h_last.rec)
        n_meas = len(ev) - n_warm
    elif args.block:
        # warm-up sized so the measured remainder is whole blocks (the tail
        # otherwise falls back to the per-scan path and compiles mid-timing)
        n_warm = min(3 * args.block, args.scans // 2)
        n_warm = args.scans - ((args.scans - n_warm) // args.block) * args.block
        if args.scans - n_warm < args.block:
            ap.error("--scans %d too small for --block %d (timed epoch would "
                     "be empty after the %d-scan warm-up); use >= %d scans"
                     % (args.scans, args.block, n_warm, 5 * args.block))
        # warm-up compiles WITHOUT draining (records stay on device until
        # the end of the stream)
        pipe.run_blocked(block=args.block, max_scans=n_warm,
                         drain_at_end=False)
        jax.block_until_ready(pipe.db.store)
        t0 = time.perf_counter()
        pipe.run_blocked(block=args.block, drain_at_end=False)
        jax.block_until_ready(pipe.db.store)
        if pipe._pending:   # force the query records too (no fetch)
            h_last = pipe._pending[-1][1]
            jax.block_until_ready(h_last.recs if hasattr(h_last, "recs")
                                  else h_last.rec)
        n_meas = len(ev) - n_warm
    else:
        n_warm = min(12, args.scans // 4)   # compile + cache warm-up scans
        for _ in range(n_warm):
            pipe.spin_once()
        t0 = time.perf_counter()
        n_meas = 0
        while pipe.spin_once():
            n_meas += 1
        jax.block_until_ready(pipe.db.store)
    steady = (time.perf_counter() - t0) / max(n_meas, 1)
    pipe.drain()
    wall = time.perf_counter() - t_all
    pipe.save_outcome(f_outcome)
    pipe.stp.print_screen()
    print("steady-state (post-warmup): %.2f ms/scan incl. load+upload"
          % (steady * 1e3))

    # the 15 s window at 1 Hz == 15-frame exclusion for gt labeling
    res = score_outcome(f_pose, f_outcome, excl_frames=15)
    tp = sum(1 for r in pipe.results if r.tfpn == 0)
    fp = sum(1 for r in pipe.results if r.tfpn == 1)
    fn = sum(1 for r in pipe.results if r.tfpn == 3)
    print("\nsynth benchmark [%s world%s]: %d scans in %.1fs "
          "(%.1f ms/scan incl. host IO)"
          % (args.world,
             ", %d dynamic objs" % args.dynamic if args.dynamic else "",
             args.scans, wall, wall / args.scans * 1e3))
    print("TFPN @ thres %.5f: tp=%d fp=%d fn=%d" %
          (cfg.correlation_thres, tp, fp, fn))
    print("max-F1 %.4f @ %.4f | recall@P=1 %.4f | TP trans mean %.3f m "
          "rmse %.3f m | rot mean %.3f deg rmse %.3f deg (%d TPs)"
          % (res.max_f1, res.max_f1_thres, res.recall_at_p1, res.trans_mean,
             res.trans_rmse, res.rot_mean_deg, res.rot_rmse_deg, res.tp_count))
    print("counters:", pipe.db.counters)

    if args.also_naive:
        f_naive = os.path.join(args.out_dir, "outcome-naive.txt")
        naive_key_outcome(pipe.db, f_naive, excl_frames=15)
        res_n = score_outcome(f_pose, f_naive, excl_frames=15)
        print("key-only baseline: max-F1 %.4f | recall@P=1 %.4f "
              "(full pipeline earns +%.4f F1)"
              % (res_n.max_f1, res_n.recall_at_p1, res.max_f1 - res_n.max_f1))
        if args.plot:
            from contour_context_tpu.eval.pr_mpe import plot_pr_curves
            plot_pr_curves([res, res_n], ["full pipeline", "key-only"],
                           args.plot)
            print("PR curves ->", args.plot)
    elif args.plot:
        from contour_context_tpu.eval.pr_mpe import plot_pr_curves
        plot_pr_curves([res], ["full pipeline"], args.plot)
        print("PR curve ->", args.plot)


if __name__ == "__main__":
    main()
