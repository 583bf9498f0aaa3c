"""Benchmark: per-scan end-to-end loop-closure latency on one GPU.

Measures the full per-scan pipeline in steady state on synthetic KITTI-scale
scans against a populated database:

  points -> descriptor build (device) -> fused query (device, one fused
  graph: search + cascade + proposal merge + GMM refine) -> DB append +
  temporal window update (device).

METHODOLOGY (chained-dispatch differencing). Every headline and scaling
number below is measured by chaining K data-dependent iterations of the work
inside ONE dispatch (lax.scan) and differencing two K values, with a real
device_get as the sync point: the dispatch overhead and fetch cost are
identical for both K and cancel, leaving (t_big - t_small) / (K_big -
K_small) of device compute.

The enqueue-side stream figure is kept as `fused_stream_enqueue_ms` (what the
host's submission loop sustains), clearly labeled enqueue-side.

The benchmark refuses to run without a GPU and exits non-zero if any phase
raised.

Compares with the reference's single-thread C++ baseline on KITTI 08
(10.8-11.2 ms/scan end-to-end, log/timing_cont2_paper.txt — see BASELINE.md).

Output protocol (robust to timeouts AND tail truncation): every stdout line
is a COMPACT JSON object (~1 KB) that carries the headline fields
(metric/value/unit/vs_baseline) — a reader that keeps only the tail of
stdout would lose a huge line with the headline at the front.
The long methodology text is emitted ONCE as its own `methodology` line up
front and never repeated. The headline line prints the moment the fused
device-time measurement exists; each completed secondary phase re-emits the
compact summary with its numbers added, so the LAST line on stdout always
holds everything measured so far, headline included. Progress narration goes
to stderr only.
"""

import json
import logging
import os
import sys
import time

import numpy as np

BASELINE_MS = 11.0  # reference end-to-end per-scan, KITTI 08


def log(msg):
    print(f"[bench +{time.perf_counter() - T0:.1f}s] {msg}",
          file=sys.stderr, flush=True)


T0 = time.perf_counter()


class CompileCounter(logging.Handler):
    """Counts XLA compilations (jax_log_compiles records) — the recompile
    audit; reported as `n_compiles`."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.count = 0

    def emit(self, record):
        if record.getMessage().startswith("Compiling "):
            self.count += 1


def main():
    sys.path.insert(0, "tests")
    from synth import make_world, render_scan

    import functools

    import jax
    import jax.numpy as jnp

    from contour_context_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {jax.devices()}")
    enable_compile_cache()
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"device {jax.devices()[0].device_kind} x{len(jax.devices())}; "
        f"nvidia-smi: {card}")
    failed_phases = []
    compile_counter = CompileCounter()
    jax.config.update("jax_log_compiles", True)
    logging.getLogger("jax").addHandler(compile_counter)

    import dataclasses

    from contour_context_tpu.config import (ContourDBConfig,
                                            ContourManagerConfig,
                                            PipelineConfig)
    from contour_context_tpu.db import (ContourDB, _localize_block,
                                        _query_step_impl, drain_block_handles,
                                        drain_handles)
    from contour_context_tpu.ops.descriptor import build_descriptor
    from contour_context_tpu.utils.io import pad_points

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=131072))
    rng = np.random.default_rng(0)
    world = make_world(1, n_structs=300, extent=400.0)

    K_FILL = 132     # warm-up scans, also the big timing chain length
    # K_SMALL must equal K_FILL mod cfg.db.desc_batch so both chains leave
    # identical vmap-chunk tail work (the r3 flattered-slope bug). 20 and
    # 132 are residue-matched for every power-of-two batch <= 16 (4 mod 16,
    # 4 mod 8, 0 mod 4/2/1), including the shipping desc_batch=1 (where
    # every length is trivially matched).
    K_SMALL = 20     # small timing chain length
    N_ENQ = 60       # enqueue-side legacy epoch length
    REPS = 3         # timing repetitions per chain length

    # enqueue-side phase (the host's submission rate), opt-in only.
    run_enq = os.environ.get("CONT2_BENCH_ENQUEUE", "0") == "1"

    # capacity: fill (6 lanes x 132) + timing reps (REPS*(K_SMALL+K_FILL)) + scan
    # cross-check (2*132) + enqueue epoch (60, opt-in) + block16 phase
    # (2 compiles 16+64, 3 reps each of 16+64 = 320) + slack — undercounting
    # triggers a grow, which recompiles every graph mid-run
    N_LANES = REPS * 2
    # + 320 block16-prebuilt rows + 320 block16-full rows + the scan
    # cross-check's 2x(K_SMALL+K_FILL); the matched phase uses its own DB
    db = ContourDB(cfg, capacity=N_LANES * K_FILL + REPS * (K_SMALL + K_FILL)
                   + 2 * (K_SMALL + K_FILL) + (N_ENQ if run_enq else 0)
                   + 640 + 8)

    # KITTI-density workload geometry (r3): six parallel one-way LANES of 132
    # scans (4 m spacing, ~528 m each, 120 m lane separation so lanes never
    # match each other), all driven once as the fill. Each timing epoch then
    # re-drives ONE lane at a 1.5 m lateral offset with fresh sensor noise —
    # every timed scan closes a loop against exactly ONE prior pass, the
    # revisit pattern of a real KITTI 08 drive (~17.9 KNN hits/scan,
    # log/timing_cont2_paper.txt). The r2 bench re-streamed the SAME
    # out-and-back clouds for every epoch, stacking matches epoch over epoch
    # (p50 600 hints/scan by the last rep, BENCH r3 interim run) — a 30x
    # denser cascade load than the workload the 11.0 ms baseline is quoted
    # on. Store: 6*132 fill + 432 timed = K08-order searchable window.
    def lane_poses(lane, dy=0.0):
        y0 = -300.0 + 120.0 * lane + dy
        return [(-264.0 + 4.0 * i, y0 + 0.5 * (i % 7), 0.05 * (i % 11))
                for i in range(K_FILL)]

    # compact transport: synthetic scans carry <=~10k real points, so host-
    # padding to max_points ships (132, 131072, 4) buffers (~277 MB/lane,
    # >90% sentinel rows) to the device. Render/upload at a compact
    # P_C and replicate pad_points' sentinel layout ON DEVICE (x=1e6,
    # y=z=flag=0) — bitwise-identical full buffers for ~10% of the bytes.
    P_C = 12288

    def render_lane(lane, dy=0.0):
        rows = []
        for p in lane_poses(lane, dy):
            pts = render_scan(world, p, seed=int(rng.integers(1 << 30)))
            assert len(pts) <= P_C, f"compact pad too small: {len(pts)}"
            rows.append(pad_points(pts, P_C))
        return np.stack(rows)

    @jax.jit
    def devpad(c):
        pad = jnp.zeros((c.shape[0], cfg.cm.max_points - P_C, 4), c.dtype)
        pad = pad.at[:, :, 0].set(1e6)
        return jnp.concatenate([c, pad], axis=1)

    def fetch1(x):
        """Sync point: fetch ONE element of a device array."""
        return jax.device_get(x.ravel()[:1])

    log(f"rendering {N_LANES} fill lanes + {N_LANES} offset epochs "
        f"({2 * N_LANES * K_FILL} scans)")
    clouds_fill = [render_lane(s) for s in range(N_LANES)]
    clouds_epoch = [render_lane(s, dy=1.5) for s in range(N_LANES)]

    handles = []
    blk_handles = []

    # EVERYTHING (compile + fill included) counts against the budget; the
    # headline is printed the moment it exists so a timeout during any later
    # phase can never lose it. A warm persistent compile cache
    # (utils/compile_cache.py) keeps reruns well inside the 520 s default.
    budget_s = float(os.environ.get("CONT2_BENCH_BUDGET", "520"))

    # one-time methodology line (stdout, compact lines only after this):
    # documents what every later line's numbers mean without bloating them
    print(json.dumps({"methodology": (
        "All *_ms are pure device time: K data-dependent iterations chained "
        "in ONE dispatch (lax.scan / fori), two K values differenced over a "
        "true device fetch — dispatch and fetch overhead cancels. "
        "Workload: synthetic KITTI-scale scans, KITTI revisit geometry "
        "(every timed scan closes a loop against ONE prior pass of its "
        "lane; searchable store ~800->1200 scans across the timed epochs). "
        "Hint density runs ~35x the reference's ~17.9 hits/scan (see "
        "hints_per_scan) so the cascade load is conservative vs the 11 ms "
        "baseline; matched_ms is the complementary number at a "
        "reference-MATCHED cascade load (hint cap 32, found-rate in "
        "'matched'). value = the dyn-trip chain executable, which IS the "
        "production step_chain_async lowering (r5); scan_chain_diff_ms = "
        "the legacy lax.scan lowering (step_chain_scan_async) differenced "
        "at the same lengths. "
        "batched_block16_prebuilt_ms excludes the descriptor build (NOT "
        "comparable to the reference's 11 ms, which is 82% build); "
        "block16_full_ms builds in-dispatch. query_*scan_db_ms are "
        "zero-live-hint probes against tiled stores (probe hint counts in "
        "query_probe_hints); localize_* serve 16-cloud blocks against "
        "frozen maps. null secondary = skipped by CONT2_BENCH_BUDGET.")},
    ), flush=True)

    def in_budget(need=0.0):
        """True if `need` more seconds still fit. Each phase passes its own
        worst-case COLD-cache cost (compile dominated; ~0 when the persistent
        cache is warm) so a single long XLA compile — which cannot be
        preempted once started — cannot blow past the budget."""
        return time.perf_counter() - T0 + need < budget_s

    # monotone seq/ts allocator: every phase draws fresh increasing ids, so
    # the _update_window_impl monotone-timestamp contract holds across phases
    next_id = [0]

    def take_ids(k):
        s = next_id[0]
        next_id[0] += k
        return s

    # ---- phase 0: fill via chained dispatches over ONE (K_FILL, ...)-shaped
    # buffer per lane. _step_chain_dyn takes the chain length as a RUNTIME
    # scalar (fori_loop), so this single compile serves the fill AND both
    # headline chain lengths — nothing else needs to compile before the
    # headline exists. -------------------------------------------------------
    log(f"fill: {N_LANES} x step_chain_dyn({K_FILL}) "
        f"(the ONE pre-headline compile)")
    for s in range(N_LANES):
        base = take_ids(K_FILL)
        ts_fill = jax.device_put(
            np.arange(base, base + K_FILL, dtype=np.float32))
        h = db.step_chain_dyn_async(
            devpad(jax.device_put(clouds_fill[s])),
            list(range(base, base + K_FILL)), ts_fill)
        blk_handles.append(h)
        jax.block_until_ready(h.recs)
    n_fill_rows = db.n
    # timing-epoch buffers stay resident (one per lane; the k=K_SMALL chains
    # use the first K_SMALL rows of their lane's buffer)
    pts_epoch = [devpad(jax.device_put(c)) for c in clouds_epoch]
    pts_fill = pts_epoch[-1]    # legacy name for the secondary phases
    log(f"fill done ({compile_counter.count} compiles so far)")

    # ---- optional enqueue-side fused stream (CONT2_BENCH_ENQUEUE=1): the
    # HOST'S submission rate for the one-dispatch-per-scan stream. ----------
    dt_enq_ms = None
    if run_enq and in_budget(150):
        log("phase fused_stream_enqueue (compiles _scan_step)")
        base = take_ids(N_ENQ)
        staged = [(pts_fill[j % K_FILL], jnp.float32(base + j))
                  for j in range(N_ENQ)]
        jax.block_until_ready(staged)
        handles.append(db.step_async(staged[0][0], base, staged[0][1]))
        jax.block_until_ready(handles[-1].rec)
        t0 = time.perf_counter()
        for j in range(1, N_ENQ):
            handles.append(db.step_async(staged[j][0], base + j,
                                         staged[j][1]))
        jax.block_until_ready(handles[-1].rec)
        dt_enq_ms = (time.perf_counter() - t0) / (N_ENQ - 1) * 1e3
        log(f"enqueue-side: {dt_enq_ms:.3f} ms/scan (submission rate)")

    # pre-stage the timing chains' ts uploads (hoisting them out of the
    # timed region).
    # Epochs interleave chain lengths across lanes (20@lane0, 132@lane1, ...)
    # so neither length systematically sees different scenes.
    chain_plan = [(K_SMALL, 2 * r) if j == 0 else (K_FILL, 2 * r + 1)
                  for r in range(REPS) for j in range(2)]
    staged_k = {k: db.stage_chain_k(k) for k in (K_SMALL, K_FILL)}
    staged_ts = []
    for k, lane in chain_plan:
        base = take_ids(k)
        staged_ts.append((k, lane, base, jax.device_put(
            np.arange(base, base + K_FILL, dtype=np.float32))))
    jax.block_until_ready([t for _, _, _, t in staged_ts]
                          + [kd for _, kd in staged_k.values()])

    # ---- HEADLINE: honest per-scan device time of the fused sequential
    # stream. chain(k) runs k data-dependent fused steps in one dispatch —
    # the SAME executable for both k (runtime trip count), so
    # (t_big - t_small)/(K_big - K_small) compares identical code and
    # cancels dispatch + fetch overhead exactly.
    n_headline_start = db.n   # hint stats scope: headline-epoch rows only
    best = {K_SMALL: None, K_FILL: None}
    for k, lane, base, ts_k in staged_ts:
        t0 = time.perf_counter()
        h = db.step_chain_dyn_async(pts_epoch[lane],
                                    list(range(base, base + k)), ts_k,
                                    k_dev=staged_k[k])
        blk_handles.append(h)
        fetch1(h.recs)
        dt = time.perf_counter() - t0
        best[k] = dt if best[k] is None else min(best[k], dt)
        log(f"chain({k}): {dt * 1e3:.1f} ms")
    n_headline_end = db.n
    t_small, t_big = best[K_SMALL], best[K_FILL]
    dt_fused_ms = (t_big - t_small) / (K_FILL - K_SMALL) * 1e3
    log(f"fused device time: {dt_fused_ms:.3f} ms/scan "
        f"(t{K_SMALL}={t_small * 1e3:.1f} ms, t{K_FILL}={t_big * 1e3:.1f} ms)")

    headline = {
        "metric": "per-scan end-to-end loop-closure DEVICE time, fused "
                  "sequential stream (see methodology line)",
        "value": round(dt_fused_ms, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / dt_fused_ms, 3),
        "chain_ms": {f"t{K_SMALL}": round(t_small * 1e3, 2),
                     f"t{K_FILL}": round(t_big * 1e3, 2)},
        "baseline_ms": BASELINE_MS,
    }
    print(json.dumps(headline), flush=True)   # the driver-safe line
    log("headline JSON emitted")

    def rnd(v):
        return round(v, 3) if v is not None else None

    # ---- incremental extended line: re-emitted after EVERY completed
    # secondary phase, so whatever the driver's kill tolerance, the LAST
    # printed JSON line carries every phase that finished (the r2 run lost
    # all secondaries to a budget overrun even though some could have fit).
    dt_scan_chain_ms = None
    dt_scan_diff_ms = None
    dt_blk_ms = None
    dt_blk_full_ms = None
    dt_matched_ms = None
    matched_info = None
    dt_big = {8192: None, 32768: None, 131072: None}
    query_hints = {8192: None, 32768: None, 131072: None}
    dt_loc_ms = {32768: None, 131072: None}

    def emit_extended():
        extended = dict(headline)
        extended.update({
            "scan_chain132_raw_ms": rnd(dt_scan_chain_ms),
            "scan_chain_diff_ms": rnd(dt_scan_diff_ms),
            "fused_stream_enqueue_ms": rnd(dt_enq_ms),
            "batched_block16_prebuilt_ms": rnd(dt_blk_ms),
            "block16_full_ms": rnd(dt_blk_full_ms),
            "matched_ms": rnd(dt_matched_ms),
            "matched": matched_info,
            "query_8192scan_db_ms": rnd(dt_big[8192]),
            "query_32768scan_db_ms": rnd(dt_big[32768]),
            "query_131072scan_db_ms": rnd(dt_big[131072]),
            "query_probe_hints": {str(k): v for k, v in query_hints.items()},
            "localize_block16_vs_32768map_ms": rnd(dt_loc_ms[32768]),
            "localize_block16_vs_131072map_ms": rnd(dt_loc_ms[131072]),
            "n_compiles": compile_counter.count,
            "budget_s": budget_s,
            "elapsed_s": round(time.perf_counter() - T0, 1),
        })
        print(json.dumps(extended), flush=True)
        return extended

    # ---- secondary phases (each budget-gated, chain timing); nothing here
    # can delay the already-emitted headline. -------------------------------
    B_BLK = 16
    NB_BIG = 4
    blk_staged = None
    if in_budget(110):
        log("staging block16 descriptors (compiles vmapped build)")
        batch_build = jax.jit(
            jax.vmap(lambda p: build_descriptor(p, cfg.cm, cfg.gmm)))
        descs_nb = jax.vmap(batch_build)(
            pts_fill[:NB_BIG * B_BLK].reshape((NB_BIG, B_BLK)
                                              + tuple(pts_fill.shape[1:])))
        descs_1 = jax.tree.map(lambda a: a[:1], descs_nb)
        jax.block_until_ready(jax.tree.leaves(descs_nb)[0])
        blk_staged = (descs_nb, descs_1)

    qdesc = None
    if in_budget(110):
        log("staging query descriptor + serving batch")
        qdesc = build_descriptor(pts_fill[0], cfg.cm, cfg.gmm)
        jax.block_until_ready(jax.tree.leaves(qdesc)[0])
    loc_pts = pts_fill[:B_BLK]

    # block-16 batched throughput: NB sequential blocks chained in one
    # dispatch; differencing NB=1 vs NB=4 isolates per-block device time.
    # Two rows: over PRE-BUILT descriptors (query+append only — the r3 row,
    # now labeled honestly) and the FULL pipeline with the descriptor build
    # in-dispatch (block_chain_pts — the row comparable to the reference's
    # 11 ms, which is 82% build).
    if blk_staged is not None and in_budget(60):
        log("phase block16 (descriptors prebuilt)")
        descs_nb, descs_1 = blk_staged

        def time_blocks(descs, nb, reps=3, full_pts=None):
            best = None
            for _ in range(reps):
                base = take_ids(nb * B_BLK)
                ts_nb = jax.device_put(
                    np.arange(base, base + nb * B_BLK,
                              dtype=np.float32).reshape(nb, B_BLK))
                seqs = list(range(base, base + nb * B_BLK))
                t0 = time.perf_counter()
                if full_pts is not None:
                    h = db.block_chain_pts_async(full_pts, seqs, ts_nb)
                else:
                    h = db.block_chain_async(descs, seqs, ts_nb)
                blk_handles.append(h)
                fetch1(h.recs)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            return best

        time_blocks(descs_1, 1, reps=1)      # compile
        time_blocks(descs_nb, NB_BIG, reps=1)
        t1 = time_blocks(descs_1, 1)
        t4 = time_blocks(descs_nb, NB_BIG)
        dt_blk_ms = (t4 - t1) / ((NB_BIG - 1) * B_BLK) * 1e3
        log(f"block16 (prebuilt descs) device time: {dt_blk_ms:.3f} ms/scan")
        emit_extended()

    if blk_staged is not None and in_budget(110):
        log("phase block16 FULL (build in-dispatch)")
        pts_1 = pts_fill[:B_BLK][None]
        pts_nb = pts_fill[:NB_BIG * B_BLK].reshape(
            (NB_BIG, B_BLK) + tuple(pts_fill.shape[1:]))
        time_blocks(None, 1, reps=1, full_pts=pts_1)     # compile
        time_blocks(None, NB_BIG, reps=1, full_pts=pts_nb)
        t1f = time_blocks(None, 1, full_pts=pts_1)
        t4f = time_blocks(None, NB_BIG, full_pts=pts_nb)
        dt_blk_full_ms = (t4f - t1f) / ((NB_BIG - 1) * B_BLK) * 1e3
        log(f"block16 FULL device time: {dt_blk_full_ms:.3f} ms/scan")
        emit_extended()

    # ---- matched-workload headline: the SAME world,
    # revisit geometry and chained-differencing methodology with the cascade
    # hint cap at 32 (~1.8x the reference's ~17.9 KNN hits/scan on KITTI 08,
    # log/timing_cont2_paper.txt:31-39) — per-scan end-to-end device time at
    # a cascade load MATCHED to the reference's profiled workload, with the
    # timed epochs' loop-found rate reported so the number cannot silently
    # trade recall for speed. scripts/matched_density_bench.py is the
    # standalone form (adds the cap-512 found-set A/B). --------------------
    if os.environ.get("CONT2_BENCH_MATCHED", "1") == "1" and in_budget(210):
        log("phase matched-workload (hint cap 32; compiles its own chain)")
        try:
            cfg_m = PipelineConfig(
                cm=ContourManagerConfig(max_points=131072),
                db=dataclasses.replace(
                    ContourDBConfig(), max_check_cands=32, cascade_chunk=0,
                    max_pass_hints=32))
            N_LANES_M, REPS_M = 2, 2
            db_m = ContourDB(cfg_m, capacity=N_LANES_M * K_FILL
                             + REPS_M * (K_SMALL + K_FILL) + 8)
            mid = [0]

            def take_m(k):
                s = mid[0]
                mid[0] += k
                return s

            for s in range(N_LANES_M):
                base = take_m(K_FILL)
                ts_f = jax.device_put(
                    np.arange(base, base + K_FILL, dtype=np.float32))
                hm = db_m.step_chain_dyn_async(
                    devpad(jax.device_put(clouds_fill[s])),
                    list(range(base, base + K_FILL)), ts_f)
                jax.block_until_ready(hm.recs)
            pts_m = [devpad(jax.device_put(clouds_epoch[s]))
                     for s in range(N_LANES_M)]
            staged_km = {k: db_m.stage_chain_k(k)
                         for k in (K_SMALL, K_FILL)}
            plan_m = []
            for _ in range(REPS_M):
                for k, lane in ((K_SMALL, 0), (K_FILL, 1)):
                    base = take_m(k)
                    plan_m.append((k, lane, base, jax.device_put(
                        np.arange(base, base + K_FILL, dtype=np.float32))))
            jax.block_until_ready([t for _, _, _, t in plan_m])
            n_m_start = db_m.n
            best_m = {K_SMALL: None, K_FILL: None}
            for k, lane, base, ts_k in plan_m:
                t0 = time.perf_counter()
                hm = db_m.step_chain_dyn_async(
                    pts_m[lane], list(range(base, base + k)), ts_k,
                    k_dev=staged_km[k])
                fetch1(hm.recs)
                dt = time.perf_counter() - t0
                best_m[k] = dt if best_m[k] is None else min(best_m[k], dt)
                log(f"matched chain({k}): {dt * 1e3:.1f} ms")
            dt_matched_ms = (best_m[K_FILL] - best_m[K_SMALL]) \
                / (K_FILL - K_SMALL) * 1e3
            recs_m = np.asarray(jax.device_get(db_m.recs_store[:db_m.n]))
            timed_m = recs_m[n_m_start:db_m.n]
            matched_info = {
                "hint_cap": 32,
                "vs_baseline": rnd(BASELINE_MS / dt_matched_ms),
                "timed_scans": int(timed_m.shape[0]),
                "loops_found_timed": int((timed_m[:, 0] > 0.5).sum()),
                "hints_precap_mean": round(float(timed_m[:, 6].mean()), 1),
            }
            log(f"matched-workload device time: {dt_matched_ms:.3f} ms/scan "
                f"(found {matched_info['loops_found_timed']}"
                f"/{matched_info['timed_scans']})")
            del db_m, pts_m
            import gc as _gc
            _gc.collect()
            emit_extended()
        except Exception as e:  # noqa: BLE001 — phase isolation by design
            log(f"matched phase FAILED: {type(e).__name__}: {str(e)[:300]}")
            failed_phases.append("matched")

    # query latency against production-scale DBs (real scans tiled to fill
    # the store — honest for search/cascade scaling; contents repeat but
    # shapes and work don't). 131072 scans ~= a 3.6 h drive @10 Hz (~4.7M
    # retrieval keys) — the city-scale serving point. The chained query
    # perturbs the float leaves of the query descriptor by a runtime (1+eps)
    # factor that is exactly 1.0f, so iterations are data-dependent (XLA
    # cannot hoist or parallelize them) but numerically identical.
    @functools.partial(jax.jit, static_argnames=("K", "pcfg"))
    def query_chain(store, keys_q, q0, searchable, K, pcfg):
        def body(q, _):
            rec = _query_step_impl(store, q, searchable, pcfg, keys_q)
            one = 1.0 + 1e-30 * rec[1]
            q = jax.tree.map(
                lambda a: a * one.astype(a.dtype)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, q)
            return q, rec
        _, recs = jax.lax.scan(body, q0, None, length=K)
        return recs

    @functools.partial(jax.jit, static_argnames=("K", "pcfg"))
    def localize_chain(store, keys_q, state, pts_b0, K, pcfg):
        def body(pts_b, _):
            recs = _localize_block(store, state, pts_b, pcfg, keys_q)
            one = 1.0 + 1e-30 * recs[0, 1]
            return pts_b * one.astype(pts_b.dtype), recs
        _, recs = jax.lax.scan(body, pts_b0, None, length=K)
        return recs

    def timed_chain(fn, k_small, k_big, reps=2):
        ts = {}
        for k in (k_small, k_big):
            fn(k)                      # compile / warm
            best = None
            for _ in range(reps):
                t0 = time.perf_counter()
                fetch1(fn(k))
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            ts[k] = best
        return (ts[k_big] - ts[k_small]) / (k_big - k_small) * 1e3

    # tile the big stores from the FIXED fill prefix (rows [0, n_fill_rows)):
    # everything before the fill is deterministic (seeded rng, fixed phase
    # order), so the tiled store CONTENT — and with it each probe query's
    # live hint count — is identical run to run. Tiling db.n rows here
    # instead would vary with the phases that had run, moving the probe's
    # cascade load across runs.
    n_have = n_fill_rows
    # the timing-epoch point buffers (6 x (132, 131072, 4) f32 ~ 1.55 GiB)
    # are dead weight past this point — only pts_epoch[0] feeds the final
    # scan-executable cross-check. The 131072-scan store is several GiB and
    # its query executable needs transient input relayouts — free the rest
    # now.
    import gc
    del pts_fill
    pts_epoch[1:] = []
    clouds_fill = clouds_epoch = None
    gc.collect()
    # worst-case COLD-cache compile at these shapes: ~40/70/190 s
    big_need = {8192: 60, 32768: 90, 131072: 150}
    for n_db in (8192, 32768, 131072) if qdesc is not None else ():
        if not in_budget(big_need[n_db]):
            break
        log(f"phase bigdb {n_db}")
        # each scale is crash-isolated: a device OOM at one scale (seen at
        # 131072) must not lose the already-measured phases or the final
        # extended line — log it, free the store, move on.
        try:
            big = ContourDB(cfg, capacity=n_db)
            reps = -(-n_db // n_have)
            big.store = jax.tree.map(
                lambda a: jnp.tile(a[:n_have],
                                   (reps,) + (1,) * (a.ndim - 1))[:n_db],
                db.store)
            from contour_context_tpu.db import _keys_to_q_layout, _kq_dtype
            big.keys_q = jax.jit(functools.partial(
                _keys_to_q_layout, dtype=_kq_dtype(cfg)))(big.store.keys)
            big.ts_store = jnp.arange(n_db, dtype=jnp.float32)
            big.state = jnp.asarray([n_db, n_db - 32], jnp.int32)
            big.n = n_db
            big.seq_of_gidx = list(range(n_db))
            # 4-vs-40 chains, best-of-3: a longer difference is less
            # sensitive to fetch noise, and lax.scan compiles its body once
            # regardless of K, so the longer chain costs no extra compile.
            dt_big[n_db] = timed_chain(
                lambda K: query_chain(big.store, big.keys_q, qdesc,
                                      big.state[1], K, cfg),
                4, 40, reps=3)
            # probe workload disclosure: the live hint count this scaling
            # point ran at (col 6 of the packed record; one tiny fetch)
            query_hints[n_db] = int(np.asarray(jax.device_get(
                query_chain(big.store, big.keys_q, qdesc, big.state[1], 4,
                            cfg)))[0, 6])
            log(f"query vs {n_db}: {dt_big[n_db]:.3f} ms "
                f"(probe hints {query_hints[n_db]})")
            emit_extended()

            # map-serving throughput: localize a block of B raw point clouds
            # against this frozen city-scale map, chained
            if n_db in dt_loc_ms and in_budget(60 if n_db < 100000 else 100):
                log(f"phase localize vs {n_db}")
                per_iter = timed_chain(
                    lambda K: localize_chain(big.store, big.keys_q, big.state,
                                             loc_pts, K, cfg), 1, 4, reps=3)
                dt_loc_ms[n_db] = per_iter / B_BLK
                log(f"localize16 vs {n_db}: {dt_loc_ms[n_db]:.3f} ms/scan")
                emit_extended()
        except Exception as e:  # noqa: BLE001 — phase isolation by design
            log(f"bigdb {n_db} FAILED: {type(e).__name__}: {str(e)[:300]}")
            failed_phases.append(f"bigdb {n_db}")
        finally:
            big = None
            gc.collect()

    # ---- dyn-vs-scan executable cross-check: the headline times the
    # runtime-trip-count fori/while chain — which IS the production
    # step_chain_async lowering (the published number is measured on the
    # executable users call). This
    # phase times the LEGACY lax.scan lowering (step_chain_scan_async) at
    # the same chain lengths to keep the loop-lowering delta on record.
    # Runs LAST: it is a methodology bound, not a headline or capability
    # metric, and its compile is the most expendable. ------------------------
    if os.environ.get("CONT2_BENCH_SCANCHK", "1") == "1" and in_budget(200):
        log("phase scan-executable cross-check (compiles _step_chain x2)")
        plan = []
        for k in (K_SMALL, K_FILL, K_SMALL, K_FILL):
            base = take_ids(k)
            plan.append((k, base, jax.device_put(
                np.arange(base, base + k, dtype=np.float32))))
        fetch1(plan[-1][2])     # sync the staged uploads out of the timing
        best_scan = {K_SMALL: None, K_FILL: None}
        for k, base, ts_s in plan:
            t0 = time.perf_counter()
            h = db.step_chain_scan_async(pts_epoch[0][:k],
                                         list(range(base, base + k)), ts_s)
            blk_handles.append(h)
            fetch1(h.recs)
            dt = time.perf_counter() - t0
            best_scan[k] = dt if best_scan[k] is None else min(best_scan[k],
                                                               dt)
        dt_scan_chain_ms = best_scan[K_FILL] * 1e3
        # the lax.scan lowering's own differenced per-scan number at both
        # chain lengths, same form as the dyn headline
        dt_scan_diff_ms = (best_scan[K_FILL] - best_scan[K_SMALL]) \
            / (K_FILL - K_SMALL) * 1e3
        log(f"scan chain({K_FILL}): {dt_scan_chain_ms:.1f} ms raw vs dyn "
            f"t{K_FILL}={t_big * 1e3:.1f} ms; differenced "
            f"{dt_scan_diff_ms:.3f} ms/scan vs headline {dt_fused_ms:.3f}")

    extended = emit_extended()

    # the stream's records live in the DB's device record ring: the whole
    # drain is ONE contiguous buffer copy (drain_handles fast path).
    log("draining records")
    results = drain_handles(handles)
    drain_block_handles(blk_handles)
    for h in blk_handles:
        results.extend(h.get())
    n_found = sum(1 for r in results if r is not None)
    # workload-density check: the reference's KITTI 08 run averages ~17.9
    # KNN hits/scan (log/timing_cont2_paper.txt); the lane geometry above is
    # built to land the TIMED scans in that regime — record the observed
    # stats so the headline comparison is verifiable. n_hints is column 6 of
    # the packed record ring (db._pack_record). Scope: ONLY the headline
    # epochs' rows — the later block16/cross-check phases re-drive already-
    # stored clouds (denser hint counts) and would inflate the statistic the
    # headline's conservativeness argument rests on.
    recs_all = np.asarray(jax.device_get(db.recs_store[:db.n]))
    hints = recs_all[:, 6]
    hint_stats = None
    headline_found = None
    if n_headline_end > n_headline_start:
        ht = hints[n_headline_start:n_headline_end]
        hint_stats = {"mean": round(float(ht.mean()), 1),
                      "p50": float(np.percentile(ht, 50)),
                      "p90": float(np.percentile(ht, 90)),
                      "max": float(ht.max()),
                      "fill_mean": round(float(hints[:n_fill_rows].mean()), 1)}
        # recall disclosure for the TIMED epochs: every
        # headline-epoch scan re-drives a filled lane at dy=1.5 m, so every
        # one is expected to close a loop — found/scans is the found-rate
        # the headline ran at (overflow-era caps could otherwise trade
        # recall for speed undetected)
        fh = recs_all[n_headline_start:n_headline_end, 0] > 0.5
        headline_found = {"scans": int(fh.size), "found": int(fh.sum()),
                          "expected": "all (pure revisit epochs)"}

    final = dict(extended)
    final.update({
        "scans": len(results),
        "loops_found": n_found,
        "hints_per_scan": hint_stats,
        "headline_found": headline_found,
        # fixed-cap truncation disclosure (drained records accumulate into
        # ContourDB.counters): non-zero overflow_pot/win would mean the
        # cascade's pair pools clipped during the timed stream — the
        # grounds on which config.p_pot could be lowered (or must not be)
        "overflow": {k: int(v) for k, v in db.counters.items()
                     if k.startswith("overflow")},
        "elapsed_s": round(time.perf_counter() - T0, 1),
    })
    final["failed_phases"] = failed_phases
    print(json.dumps(final), flush=True)
    if failed_phases:
        raise SystemExit(f"bench phases failed: {failed_phases}")
    log("done")


if __name__ == "__main__":
    main()
