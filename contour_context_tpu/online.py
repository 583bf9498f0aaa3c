"""Online streaming mode: per-scan loop detection on a live scan feed.

The analog of the reference's online shell (bag_play_test.cpp:
188-344 + BaseROSSpinner, spinner_ros.h:27-206) without ROS: scans are pushed
into a bounded queue by any producer (sensor driver, bag reader, socket); a
spinner thread runs the same device pipeline as the batch driver and emits
`LoopDetection`s through a callback. Control mirrors the `/cont2_status`
topic (spinner_ros.h:73-100): `pause()` / `resume()` / `terminate()` from
code, or the same words written to a watched control file from another
process (the rostopic-pub equivalent).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from contour_context_tpu.config import PipelineConfig
from contour_context_tpu.db import ContourDB, drain_handles
from contour_context_tpu.ops.descriptor import build_descriptor
from contour_context_tpu.utils.io import pad_points


@dataclass
class LoopDetection:
    q_seq: int
    cand_seq: int
    correlation: float
    T_delta: np.ndarray     # (3,) x, y, theta (BEV frame)


class OnlineSpinner:
    """Streaming loop-closure detector with pause/resume/terminate control."""

    def __init__(self, cfg: PipelineConfig, capacity: int = 8192,
                 on_loop: Optional[Callable[[LoopDetection], None]] = None,
                 control_file: Optional[str] = None,
                 drain_block: int = 8, queue_depth: int = 32,
                 fused_step: bool = True):
        self.cfg = cfg
        # ONE device dispatch per scan (db.step_async) — lowest latency for a
        # live feed; semantics identical to the 4-dispatch path (parity test
        # test_fused_query.py::test_scan_step_matches_unfused)
        self.fused_step = fused_step
        self.db = ContourDB(cfg, capacity)
        self.on_loop = on_loop
        self.control_file = control_file
        self.drain_block = drain_block
        self.detections: List[LoopDetection] = []
        self.n_processed = 0
        # scans left unprocessed when the loop exits (terminate, or
        # end-of-stream while paused): a truncated stream must be
        # distinguishable from a clean finish
        self.dropped = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._paused = threading.Event()
        self._terminate = threading.Event()
        self._eos = threading.Event()
        self._pending: list = []
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    # -- control (the /cont2_status analog) --------------------------------

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def terminate(self) -> None:
        self._terminate.set()

    def _poll_control_file(self) -> None:
        if not self.control_file or not os.path.exists(self.control_file):
            return
        try:
            cmd = open(self.control_file).read().strip().lower()
        except OSError:
            return
        if cmd == "pause":
            self.pause()
        elif cmd in ("resume", "continue"):
            self.resume()
        elif cmd in ("end", "terminate", "stop"):
            self.terminate()

    # -- feeding ------------------------------------------------------------

    def feed(self, points: np.ndarray, seq: int, ts: float,
             timeout: Optional[float] = None) -> bool:
        """Enqueue one scan ((N,3) xyz or padded (P,4)); False if terminated
        or the queue stayed full past `timeout`."""
        if self._terminate.is_set():
            return False
        try:
            self._q.put((points, seq, ts), timeout=timeout)
            return True
        except queue.Full:
            return False

    def finish(self) -> None:
        """Signal end-of-stream and wait for the spinner to drain.

        Never blocks: end-of-stream is an event the spin loop checks (even
        while paused), not only a queue sentinel, so a full queue or a
        paused/dead spinner cannot deadlock the caller. Re-raises any error
        that killed the spin thread (e.g. a device failure mid-stream)."""
        self._eos.set()
        try:
            self._q.put_nowait(None)     # wake a blocked get() promptly
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join()
        if self.error is not None:
            raise self.error

    # -- the spin loop --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self.spin, daemon=True)
        self._thread.start()

    def _drain(self, k: int) -> None:
        batch = self._pending[:k]
        del self._pending[:k]
        for seq, res in zip((b[0] for b in batch),
                            drain_handles([b[1] for b in batch])):
            self.n_processed += 1
            if res is None:
                continue
            gidx, corr, T3 = res
            det = LoopDetection(seq, self.db.seq_of_gidx[gidx], corr, T3)
            self.detections.append(det)
            if self.on_loop is not None:
                self.on_loop(det)

    def spin(self) -> None:
        """Process the queue until terminate or end-of-stream.

        Any exception (device failures included) is recorded in self.error
        and re-raised by finish() — a dying daemon thread must not look like
        a clean, merely-short stream."""
        try:
            self._spin_impl()
        except BaseException as e:      # noqa: BLE001 — forwarded to finish()
            self.error = e

    def _spin_impl(self) -> None:
        import jax

        cfg = self.cfg
        while not self._terminate.is_set():
            self._poll_control_file()
            if self._paused.is_set():
                if self._eos.is_set():
                    break               # end-of-stream overrides pause
                import time as _t
                _t.sleep(0.02)
                continue
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._eos.is_set():
                    break
                continue
            if item is None:
                break
            pts, seq, ts = item
            if pts.ndim != 2 or pts.shape != (cfg.cm.max_points, 4):
                pts = pad_points(pts, cfg.cm.max_points)
            dev_pts, dev_ts = jax.device_put((pts, np.float32(ts)))
            if self.fused_step:
                h = self.db.step_async(dev_pts, seq, dev_ts)
            else:
                desc = build_descriptor(dev_pts, cfg.cm, cfg.gmm)
                h = self.db.query_async(desc)
                self.db.add_scan(desc, seq, dev_ts)
                self.db.push_and_balance(dev_ts)
            self._pending.append((seq, h))
            if len(self._pending) >= 2 * self.drain_block:
                self._drain(self.drain_block)
        while True:         # count scans the exit left in the queue
            try:
                if self._q.get_nowait() is not None:
                    self.dropped += 1
            except queue.Empty:
                break
        self._drain(len(self._pending))
