"""CLI batch driver: the cont2_batch_bin_test executable, config-file driven.

    python -m contour_context_tpu --config batch_bin_test_config.yaml
    python -m contour_context_tpu --pose ts-sens_pose.txt --laser ts-lidar_bins.txt \\
        --outcome outcome.txt [--max-scans N] [--timing-log log/timing.txt]

The YAML schema is the reference's (config/batch_bin_test_config.yaml),
including the IO paths fpath_sens_gt_pose / fpath_lidar_bins /
fpath_outcome_sav; flags override the file.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from contour_context_tpu.config import PipelineConfig, load_pipeline_config_yaml


def main(argv: Optional[Sequence[str]] = None):
    """Replay a sequence; returns the finished LoopClosurePipeline."""
    ap = argparse.ArgumentParser(prog="python -m contour_context_tpu",
                                 description=__doc__)
    ap.add_argument("--config", help="reference-format YAML config")
    ap.add_argument("--pose", help="gt sensor pose file (13 cols/line)")
    ap.add_argument("--laser", help="scan list file (ts seq path)")
    ap.add_argument("--outcome", help="outcome file to write")
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--timing-log", help="append the stage-timing report here")
    ap.add_argument("--save-mid-dir",
                    help="write per-scan contour dumps + BEV images here")
    ap.add_argument("--fused-step", action="store_true",
                    help="one device dispatch per scan (lowest latency; "
                         "collapses the per-stage timing report; ignored "
                         "when --save-mid-dir is set, which needs the "
                         "descriptor on host)")
    ap.add_argument("--trace-dir",
                    help="capture a jax.profiler trace of the replay into "
                         "this directory (open with TensorBoard / Perfetto; "
                         "complements the 5-stage wall-time report)")
    ap.add_argument("--chain", type=int, default=None, metavar="K",
                    help="replay K scans per device dispatch with exact "
                         "per-scan sequential semantics (step_chain_async; "
                         "valid at any timestamp spacing, unlike the batched "
                         "block mode)")
    args = ap.parse_args(argv)

    cfg = PipelineConfig()
    io_paths = {}
    if args.config:
        cfg, io_paths = load_pipeline_config_yaml(args.config)
    fpath_pose = args.pose or io_paths.get("fpath_sens_gt_pose")
    fpath_laser = args.laser or io_paths.get("fpath_lidar_bins")
    fpath_outcome = args.outcome or io_paths.get("fpath_outcome_sav")
    if not (fpath_pose and fpath_laser and fpath_outcome):
        ap.error("need --pose/--laser/--outcome (or a --config providing "
                 "fpath_sens_gt_pose/fpath_lidar_bins/fpath_outcome_sav)")

    from contour_context_tpu.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu.pipeline import LoopClosurePipeline
    from contour_context_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    ev = ContLCDEvaluator(fpath_pose, fpath_laser, cfg.correlation_thres)
    pipe = LoopClosurePipeline(cfg, ev, capacity=max(len(ev) + 8, 64),
                               save_mid_dir=args.save_mid_dir,
                               fused_step=args.fused_step)
    import contextlib

    if args.trace_dir:
        import jax

        trace_cm = jax.profiler.trace(args.trace_dir)
    else:
        trace_cm = contextlib.nullcontext()
    with trace_cm:
        if args.chain:
            pipe.run_chained(chain=args.chain, max_scans=args.max_scans)
        else:
            pipe.run(max_scans=args.max_scans, progress_every=200)
    pipe.save_outcome(fpath_outcome)
    pipe.stp.print_screen()
    if args.timing_log:
        pipe.stp.print_file(args.timing_log)
    tp = sum(1 for r in pipe.results if r.tfpn == 0)
    fp = sum(1 for r in pipe.results if r.tfpn == 1)
    fn = sum(1 for r in pipe.results if r.tfpn == 3)
    print("done: %d scans, tp=%d fp=%d fn=%d -> %s"
          % (len(pipe.results), tp, fp, fn, fpath_outcome))
    return pipe


if __name__ == "__main__":
    main()
