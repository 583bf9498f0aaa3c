"""End-to-end loop-closure pipeline: the batch_bin_test replay loop.

Replays a sequence (test/batch_bin_test.cpp:105-248): per scan,
build descriptor (device) -> fused query step (device, ONE dispatch) -> add to
DB -> advance the temporal insertion window.  Query results are fetched with
async host copies and drained a few scans behind the head, so the steady-state
loop never blocks on the host<->device link; TFPN recording happens at drain
time in scan order.  Produces an outcome file scored by eval/pr_mpe.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from contour_context_tpu.config import PipelineConfig
from contour_context_tpu.db import (ContourDB, QueryHandle,
                                    drain_block_handles, drain_handles)
from contour_context_tpu.eval.evaluator import ContLCDEvaluator
from contour_context_tpu.ops.descriptor import build_descriptor
from contour_context_tpu.utils.io import pad_points
from contour_context_tpu.utils.se2 import se2_mat
from contour_context_tpu.utils.profiling import SequentialTimeProfiler

DRAIN_BLOCK = 4096   # pending-record bound before a mid-stream drain
# Mid-stream drains are a last-resort memory bound: the pipeline holds the
# tiny (18-float) records on device and drains once at the end of the stream,
# so the steady-state loop never waits on a device->host fetch. Use
# OnlineSpinner when per-scan results are needed live.


@dataclass
class LoopResult:
    q_seq: int
    cand_seq: Optional[int]
    correlation: float
    tfpn: int


class LoopClosurePipeline:
    """Streaming per-scan loop: the reference's BatchBinSpinner equivalent."""

    def __init__(self, cfg: PipelineConfig, evaluator: ContLCDEvaluator,
                 capacity: int = 8192, block_for_timing: bool = False,
                 save_mid_dir: Optional[str] = None,
                 q16_transport: bool = False,
                 fused_step: bool = False):
        self.cfg = cfg
        self.evaluator = evaluator
        self.db = ContourDB(cfg, capacity)
        self.stp = SequentialTimeProfiler("cont2-tpu batch")
        self.results: List[LoopResult] = []
        self.block = block_for_timing
        # SAVE_MID_FILE equivalent (contour_mng.h:547-555, CMakeLists.txt:17):
        # per-scan contour dumps + BEV images. Debug only: it fetches the
        # descriptor to host every scan, which stalls the stream.
        self.save_mid_dir = save_mid_dir
        # int16 fixed-point wire format (1/256 m): halves upload bytes on
        # bandwidth-limited host links; dequantized on device (descriptor
        # parity within mm-scale quantization, tests/test_descriptor.py)
        self.q16_transport = q16_transport
        # ONE dispatch per scan (db.step_async: build+query+append+window)
        # instead of four — the lowest-latency streaming mode. Mutually
        # exclusive with save_mid_dir (which needs the descriptor on host)
        # and collapses the per-stage timing report into one "scan step" row.
        if fused_step and save_mid_dir is not None:
            print("warning: fused_step disabled — save_mid_dir needs the "
                  "descriptor on host (falling back to the 4-dispatch path)")
        self.fused_step = fused_step and save_mid_dir is None
        self._pending: deque = deque()   # (LaserScanInfo, QueryHandle|None)
        self._prefetched = None          # (seq, (dev_pts, dev_ts))
        # native C++ mmap reader when csrc/libcont2.so builds; numpy otherwise
        from contour_context_tpu.utils.native_loader import read_bin_padded
        self._load_points: Callable[[str], np.ndarray] = \
            lambda p: read_bin_padded(p, cfg.cm.max_points)
        self._default_loader = True   # enables zero-copy block staging

    def set_point_loader(self, fn: Callable[[str], np.ndarray]) -> None:
        """Override the scan loader; may return (N,3) xyz or padded (P,4)."""
        self._load_points = fn
        self._default_loader = False

    def _ensure_padded(self, pts: np.ndarray) -> np.ndarray:
        if pts.ndim != 2 or pts.shape != (self.cfg.cm.max_points, 4):
            pts = pad_points(pts, self.cfg.cm.max_points)
        return pts

    def _upload(self, info):
        """Load one scan and start its async (points, ts) device upload."""
        import jax

        pts = self._ensure_padded(self._load_points(info.fpath))
        if self.q16_transport:
            from contour_context_tpu.utils.io import quantize_points_q16
            pts = quantize_points_q16(pts)
        return jax.device_put((pts, np.float32(info.ts)))

    def _process(self, info, res) -> None:
        cfg = self.cfg
        if res is None:
            pred = self.evaluator.add_prediction(info.seq, 0.0)
            lr = LoopResult(info.seq, None, 0.0, pred.tfpn)
        else:
            gidx, corr, T3 = res
            cand_seq = self.db.seq_of_gidx[gidx]
            pred = self.evaluator.add_prediction(info.seq, corr, cand_seq,
                                                 se2_mat(T3[0], T3[1], T3[2]),
                                                 cfg.cm.n_row, cfg.cm.n_col,
                                                 cfg.cm.reso_row,
                                                 cfg.cm.reso_col)
            lr = LoopResult(info.seq, cand_seq, corr, pred.tfpn)
        self.results.append(lr)

    def _drain_block(self, k: int) -> None:
        batch = [self._pending.popleft() for _ in range(k)]
        scalars = [h for info, h in batch if not isinstance(info, list)]
        scal_res = iter(drain_handles(scalars))
        # all block records leave the device as ONE stacked copy; the
        # per-handle get() below then reads the cached host rows
        drain_block_handles([h for info, h in batch if isinstance(info, list)])
        for info, h in batch:
            if isinstance(info, list):     # a processed block
                for i, res in zip(info, h.get()):
                    self._process(i, res)
            else:
                self._process(info, next(scal_res))

    def drain(self) -> None:
        """Materialize every pending query result (end of the stream)."""
        if self._pending:
            self._drain_block(len(self._pending))

    def spin_once(self) -> bool:
        """Process the next scan; returns False when the sequence ends."""
        ev = self.evaluator
        if not ev.load_new_scan():
            return False
        self._spin_info(ev.curr_scan)
        return True

    def _spin_info(self, info, prefetch: bool = True) -> None:
        """Per-scan step for one LaserScanInfo (cursor already advanced)."""
        import jax

        ev = self.evaluator
        cfg = self.cfg

        self.stp.lap()
        self.stp.start()
        # one upload per scan: points + timestamp ride together; the NEXT
        # scan's upload is issued before this scan's work is awaited (1-deep
        # prefetch), so the link pipelines with compute
        if self._prefetched is not None and self._prefetched[0] == info.seq:
            dev_pts, dev_ts = self._prefetched[1]
        else:
            dev_pts, dev_ts = self._upload(info)
        self._prefetched = None
        nxt = ev.peek_next() if prefetch else None
        if nxt is not None:
            self._prefetched = (nxt.seq, self._upload(nxt))
        if self.fused_step:
            handle = self.db.step_async(dev_pts, info.seq, dev_ts)
            if self.block:
                jax.block_until_ready(handle.rec)
            self.stp.record("scan step (fused)")
            self._pending.append((info, handle))
            if len(self._pending) >= 2 * DRAIN_BLOCK:
                self._drain_block(DRAIN_BLOCK)
            return
        desc = build_descriptor(dev_pts, cfg.cm, cfg.gmm)
        if self.block:
            jax.block_until_ready(desc)
        self.stp.record("make bev")
        if self.save_mid_dir is not None:
            import os

            from contour_context_tpu.ops.descriptor import rasterize_bev
            from contour_context_tpu.utils.dumps import (
                save_bev_image, save_contours)

            host_desc = jax.device_get(desc)
            save_contours(os.path.join(
                self.save_mid_dir, "contours-%06d.txt" % info.seq),
                host_desc, cfg.cm)
            bev, _, _ = rasterize_bev(dev_pts, cfg.cm)
            save_bev_image(os.path.join(
                self.save_mid_dir, "bev-%06d.png" % info.seq),
                np.asarray(bev).reshape(cfg.cm.n_row, cfg.cm.n_col))

        handle = self.db.query_async(desc)
        if self.block and handle is not None:
            jax.block_until_ready(handle.rec)
        self.stp.record("query (fused)")
        self._pending.append((info, handle))

        self.stp.start()
        self.db.add_scan(desc, info.seq, dev_ts)
        self.db.push_and_balance(dev_ts)
        self.stp.record("Update database")

        if len(self._pending) >= 2 * DRAIN_BLOCK:
            self._drain_block(DRAIN_BLOCK)

    def _stage_group(self, infos, slot: int):
        """Shared staging for run_blocked/run_chained: read `infos` straight
        into one of two reusable block buffers (native thread pool; no
        np.stack realloc+copy, which otherwise dominates at ~87 ms/block),
        optionally q16-quantize, and upload. Returns (dev_pts, dev_ts).

        Double-buffered with consumer pinning: a slot's buffer is reused only
        after the device consumer registered via _pin_group ran — on CPU
        device_put aliases host memory (zero-copy), so waiting on the
        transfer alone lets an async consumer read bytes of a later group
        (caught as corr=1.0 self-matches two blocks apart). Every caller MUST
        _pin_group(slot, <device output that read the upload>)."""
        import jax

        cfg = self.cfg
        group = len(infos)
        if getattr(self, "_grp_bufs", None) is None or \
                self._grp_bufs[0].shape != (group, cfg.cm.max_points, 4):
            self._grp_bufs = [
                np.empty((group, cfg.cm.max_points, 4), np.float32)
                for _ in range(2)]
            self._grp_prev = [None, None]
        if self._grp_prev[slot] is not None:
            jax.block_until_ready(self._grp_prev[slot])
        buf = self._grp_bufs[slot]
        if self._default_loader:
            from contour_context_tpu.utils.native_loader import (
                read_block_into)

            read_block_into([i.fpath for i in infos], buf)
        else:
            for j, info in enumerate(infos):
                buf[j] = self._ensure_padded(self._load_points(info.fpath))
        ts = np.asarray([i.ts for i in infos], np.float32)
        if self.q16_transport:
            from contour_context_tpu.utils.io import quantize_points_q16
            send = quantize_points_q16(
                buf.reshape(-1, 4)).reshape(buf.shape)  # fresh array
        else:
            send = buf
        return jax.device_put((send, ts))

    def _pin_group(self, slot: int, consumer) -> None:
        self._grp_prev[slot] = consumer

    def run_blocked(self, block: int = 16, max_scans: Optional[int] = None,
                    drain_at_end: bool = True) -> None:
        """Batched replay: `block` scans per device dispatch.

        Descriptor builds are vmapped over the block and the whole block is
        appended + queried by ONE fused dispatch (db._process_block) with
        exact sequential-window parity — the throughput mode (see bench.py's
        batched_block16_prebuilt_ms)."""
        import jax

        ev = self.evaluator
        cfg = self.cfg
        if getattr(self, "_batch_build_B", None) != block:
            self._batch_build = jax.jit(jax.vmap(
                lambda p: build_descriptor(p, cfg.cm, cfg.gmm)))
            self._batch_build_B = block

        n_done = 0
        while max_scans is None or n_done < max_scans:
            infos = []
            while len(infos) < block and \
                    (max_scans is None or n_done + len(infos) < max_scans) \
                    and ev.load_new_scan():
                infos.append(ev.curr_scan)
            if not infos:
                break
            if len(infos) < block:
                # tail shorter than a block: per-scan path (padding with
                # duplicate scans would pollute the searchable store).
                # prefetch off: the cursor is past the tail, so peek_next
                # would re-upload an unrelated scan once per tail scan
                for info in infos:
                    self._spin_info(info, prefetch=False)
                n_done += len(infos)
                break
            self.stp.lap()
            self.stp.start()
            slot = (n_done // block) % 2
            dev_pts, dev_ts = self._stage_group(infos, slot)
            descs = self._batch_build(dev_pts)
            # pinning the descriptors covers both the transfer and the read
            self._pin_group(slot, descs)
            self.stp.record("make bev")
            self.stp.start()
            h = self.db.process_block_async(descs, [i.seq for i in infos],
                                            dev_ts)
            self.stp.record("block append+query")
            self._pending.append((infos, h))
            n_done += len(infos)
        if drain_at_end:
            self.drain()

    def run_chained(self, chain: int = 16, max_scans: Optional[int] = None,
                    drain_at_end: bool = True) -> None:
        """Chained replay: `chain` scans per device dispatch with EXACT
        per-scan sequential semantics (db.step_chain_async — a lax.scan over
        the fused per-scan step, so query_i sees every append/window update
        of scans < i regardless of timestamp spacing, unlike run_blocked's
        batched queries which need the >= min_elapse gap). Use for irregular
        streams (e.g. MulRan reindexed timestamps) at block-mode dispatch
        overhead."""
        import jax

        ev = self.evaluator
        cfg = self.cfg
        n_done = 0
        while max_scans is None or n_done < max_scans:
            infos = []
            while len(infos) < chain and \
                    (max_scans is None or n_done + len(infos) < max_scans) \
                    and ev.load_new_scan():
                infos.append(ev.curr_scan)
            if not infos:
                break
            if len(infos) < chain:
                # tail shorter than the compiled chain: per-scan path
                for info in infos:
                    self._spin_info(info, prefetch=False)
                n_done += len(infos)
                break
            self.stp.lap()
            self.stp.start()
            slot = (n_done // chain) % 2
            dev_pts, dev_ts = self._stage_group(infos, slot)
            self.stp.record("stage+upload")
            self.stp.start()
            h = self.db.step_chain_async(dev_pts, [i.seq for i in infos],
                                         dev_ts)
            self._pin_group(slot, h.recs)
            self.stp.record("chain step")
            self._pending.append((infos, h))
            n_done += len(infos)
        if drain_at_end:
            self.drain()

    def run(self, max_scans: Optional[int] = None, progress_every: int = 0,
            trace_dir: Optional[str] = None) -> None:
        """Replay the whole sequence; `trace_dir` wraps the loop in a
        jax.profiler trace (open with TensorBoard / xprof)."""
        if trace_dir:
            import jax

            with jax.profiler.trace(trace_dir):
                self.run(max_scans=max_scans, progress_every=progress_every)
            return
        n = 0
        while self.spin_once():
            n += 1
            if progress_every and n % progress_every == 0:
                # results populate only at drain (records stay on device to
                # keep the stream fetch-free) — report the pending depth so
                # all-zero counts aren't mistaken for "no loops found"
                tp = sum(1 for r in self.results if r.tfpn == 0)
                fp = sum(1 for r in self.results if r.tfpn == 1)
                fn = sum(1 for r in self.results if r.tfpn == 3)
                print("[%d] drained: tp=%d fp=%d fn=%d (pending on device: %d)"
                      % (n, tp, fp, fn, len(self._pending)), flush=True)
            if max_scans is not None and n >= max_scans:
                break
        self.drain()

    def save_outcome(self, path: str) -> None:
        self.evaluator.save_prediction_results(path)


def run_batch(fpath_pose: str, fpath_laser: str, outcome_path: str,
              cfg: Optional[PipelineConfig] = None,
              max_scans: Optional[int] = None,
              fused_step: bool = False) -> LoopClosurePipeline:
    """The cont2_batch_bin_test entry point (batch_bin_test.cpp:261-307)."""
    cfg = cfg or PipelineConfig()
    ev = ContLCDEvaluator(fpath_pose, fpath_laser, cfg.correlation_thres)
    pipe = LoopClosurePipeline(cfg, ev, capacity=max(len(ev) + 8, 64),
                               fused_step=fused_step)
    pipe.run(max_scans=max_scans, progress_every=200)
    pipe.save_outcome(outcome_path)
    pipe.stp.print_screen()
    return pipe
