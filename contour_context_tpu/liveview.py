"""Live loop-closure view: the rviz connection-line display without ROS.

The reference's online shell publishes the trajectory and every accepted loop
as a green (TP) / red (FP) line strip to rviz while the bag plays
(BaseROSSpinner::publishLCConnections + publishPath, spinner_ros.h:147-196).
This module is that view without ROS: an incrementally-updated matplotlib
figure that renders the growing trajectory and loop connections while the
stream runs — to an interactive window when a GUI backend is available, and
always to a continuously-rewritten PNG (the headless "rviz").

Wiring (see tests/test_liveview.py and scripts/live_demo.py):

    view = LiveLoopView("live.png", gt_xy=poses_xy, every=5)
    spinner = OnlineSpinner(cfg, on_loop=view.add_loop)
    ...
    for seq, pose in stream:
        view.add_pose(seq, pose[0], pose[1])
        spinner.feed(...)
    view.render(final=True)

Thread model: `add_loop` is called from the spinner's drain thread and
`add_pose` from the feeder; both only append to lock-guarded buffers.
Rendering happens in `render()` on whichever thread calls it (matplotlib is
not thread-safe; the spinner never renders). `every=N` makes `add_loop`
request a render every N detections, honored at the next `render()` /
`maybe_render()` call on the owning thread.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

TP_COLOR = "#228833"    # green connection (matches scripts/plot_loops.py)
FP_COLOR = "#cc3311"    # red connection
PATH_COLOR = "#bbbbbb"


class LiveLoopView:
    """Incrementally-drawn trajectory + loop-connection figure."""

    def __init__(self, out_path: str, gt_xy: Optional[np.ndarray] = None,
                 gt_radius: float = 5.0, every: int = 1,
                 figsize=(8.0, 8.0), interactive: Optional[bool] = None):
        """gt_xy: optional (N, 2) ground-truth positions by seq. When given,
        loops are colored green/red by the same <=`gt_radius` m criterion the
        evaluator uses (evaluator.h:305-368); without gt every loop draws
        green (online, truth unknown — the reference's bag shell has gt via
        the evaluator, so color fidelity matches when you pass it)."""
        import matplotlib

        if interactive is None:
            interactive = matplotlib.get_backend().lower() not in (
                "agg", "pdf", "svg", "ps", "template")
        if not interactive:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        self._plt = plt
        self.out_path = out_path
        self.gt_xy = None if gt_xy is None else np.asarray(gt_xy, np.float64)
        self.gt_radius = float(gt_radius)
        self.every = max(1, int(every))
        self.interactive = bool(interactive)

        self._lock = threading.Lock()
        self._poses: list = []          # (seq, x, y) in feed order
        self._loops: list = []          # (q_seq, cand_seq, correlation)
        self._drawn_poses = 0
        self._taken_loops = 0
        self._pending_loops: list = []  # taken but endpoint pose not yet fed
        self._render_due = False
        self.n_tp = 0
        self.n_fp = 0

        self._xy_by_seq: dict = {}
        self.fig, self.ax = plt.subplots(figsize=figsize)
        self.ax.set_aspect("equal")
        self.ax.set_title("cont2-tpu live loops")
        self._path_line, = self.ax.plot([], [], "-", color=PATH_COLOR,
                                        lw=0.8, zorder=1)
        if self.interactive:
            plt.ion()
            self.fig.show()

    # -- feed side (any thread; no matplotlib calls) ------------------------

    def add_pose(self, seq: int, x: float, y: float) -> None:
        with self._lock:
            self._poses.append((int(seq), float(x), float(y)))

    def add_loop(self, det) -> None:
        """OnlineSpinner.on_loop-compatible: det has q_seq, cand_seq,
        correlation (online.LoopDetection); plain tuples work too."""
        if hasattr(det, "q_seq"):
            item = (int(det.q_seq), int(det.cand_seq), float(det.correlation))
        else:
            q, c = det[0], det[1]
            item = (int(q), int(c), float(det[2]) if len(det) > 2 else 1.0)
        with self._lock:
            self._loops.append(item)
            if len(self._loops) - self._taken_loops >= self.every:
                self._render_due = True

    # -- render side (owning thread only) -----------------------------------

    def _loop_color(self, q_seq: int, cand_seq: int) -> str:
        if self.gt_xy is None:
            return TP_COLOR
        n = len(self.gt_xy)
        if not (0 <= q_seq < n and 0 <= cand_seq < n):
            return FP_COLOR
        d = float(np.linalg.norm(self.gt_xy[q_seq] - self.gt_xy[cand_seq]))
        return TP_COLOR if d <= self.gt_radius else FP_COLOR

    def maybe_render(self) -> bool:
        """Render only if enough new loops arrived (the `every` cadence)."""
        with self._lock:
            due = self._render_due
        if due:
            self.render()
        return due

    def render(self, final: bool = False) -> None:
        with self._lock:
            poses = self._poses[:]
            loops = self._loops[:]
            self._render_due = False
        for seq, x, y in poses[self._drawn_poses:]:
            self._xy_by_seq[seq] = (x, y)
        self._drawn_poses = len(poses)
        if poses:
            xs = [p[1] for p in poses]
            ys = [p[2] for p in poses]
            self._path_line.set_data(xs, ys)
            self.ax.relim()
            self.ax.autoscale_view()
        # A loop may arrive from the drain thread before its endpoint pose is
        # fed; such loops stay pending and are retried every render, so the
        # feed/detect ordering between threads never loses a connection.
        self._pending_loops.extend(loops[self._taken_loops:])
        self._taken_loops = len(loops)
        still_pending = []
        for q_seq, cand_seq, _corr in self._pending_loops:
            a = self._xy_by_seq.get(q_seq)
            b = self._xy_by_seq.get(cand_seq)
            if a is None or b is None:
                still_pending.append((q_seq, cand_seq, _corr))
                continue
            color = self._loop_color(q_seq, cand_seq)
            if color == TP_COLOR:
                self.n_tp += 1
            else:
                self.n_fp += 1
            self.ax.plot([a[0], b[0]], [a[1], b[1]], "-", color=color,
                         lw=1.0, zorder=2)
        self._pending_loops = still_pending
        self.ax.set_xlabel(f"x [m]   TP(green)={self.n_tp}  "
                           f"FP(red)={self.n_fp}")
        if self.interactive:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
        if final or not self.interactive:
            self.fig.savefig(self.out_path, dpi=110)

    def close(self) -> None:
        self.render(final=True)
        self._plt.close(self.fig)
