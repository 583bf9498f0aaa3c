"""Bound the temporal-window STAGGER deviation.

The reference pops tree-bucket buffers one adjacent bucket pair per scan on a
triangle-wave schedule (contour_db.h:827-843, contour_db.cpp:63-317), so a
key becomes searchable with a bucket-phase-dependent stagger of a few scans.
The device DB pops one GLOBAL searchable prefix (db._update_window_impl). This
test drives BOTH models — the faithful host replica oracle.RefLayerDB vs a
numpy twin of _update_window_impl — over a long synthetic key trace and
quantifies the divergence per key:

- the >=min_elapse exclusion contract holds in both models for EVERY key,
- every key is searchable in both models once it is older than
  max_elapse + one triangle period (the wave visits a bucket's pair within
  8 scans), and
- the maximum per-key searchability-onset difference is named in scans and
  bounded by the (max_elapse - min_elapse) trigger band + wave period.

These tests are pure host (no jax) and run in milliseconds per thousand
scans.
"""

import numpy as np

from contour_context_tpu.oracle import (
    NUM_BUCKETS,
    RefLayerDB,
    triangle_pair_index,
)

MIN_ELAPSE = 15.0
MAX_ELAPSE = 25.0
WAVE_PERIOD = 2 * (NUM_BUCKETS - 2)          # 8 scans


def _repo_pop_times(ts: np.ndarray) -> np.ndarray:
    """Numpy twin of db._update_window_impl driven once per scan: returns the
    scan index at which each scan's keys became searchable (-1 = never)."""
    n = len(ts)
    pop_scan = np.full(n, -1, np.int64)
    pop_ptr = 0
    for i in range(n):
        t = ts[i]
        # state after appending scan i: rows 0..i exist
        oldest = ts[pop_ptr] if pop_ptr <= i else np.inf
        if pop_ptr <= i and oldest <= t - MAX_ELAPSE:
            k = int(np.sum(ts[: i + 1] < t - MIN_ELAPSE))
            new_ptr = max(k, pop_ptr)
            pop_scan[pop_ptr:new_ptr] = i
            pop_ptr = new_ptr
    return pop_scan


def _drive(ts, keys_per_scan, n_levels=3):
    """Run the reference schedule over a key trace.

    keys_per_scan: list (per scan) of per-level lists of k0 values.
    Returns {(level, scan, seq): pop_scan_index} and the LayerDBs."""
    dbs = [RefLayerDB(MIN_ELAPSE, MAX_ELAPSE) for _ in range(n_levels)]
    for i, t in enumerate(ts):
        for lv in range(n_levels):
            for seq, k0 in enumerate(keys_per_scan[i][lv]):
                dbs[lv].push_buffer(float(k0), float(t), (lv, i, seq))
        # pushAndBalance: one bucket pair per scan, every q-level
        # (contour_db.h:827-843)
        pair = triangle_pair_index(i)
        for db in dbs:
            db.clock = i
            db.rebuild(pair, float(t))
    return {k: v for db in dbs for k, v in db.pop_log.items()}, dbs


def _key_trace(rng, n_scans, n_levels=3, n_anchor=6):
    """k0 values from a clustered lognormal: large common mass plus a heavy
    tail, so buckets imbalance and the rebalance/split path actually runs."""
    return [[rng.lognormal(1.5, 0.8, n_anchor) * 3.0
             for _ in range(n_levels)] for _ in range(n_scans)]


def test_stagger_divergence_bounded_10hz():
    """KITTI-rate trace (10 Hz): the per-key searchability onset of the
    reference's staggered schedule and the device global-prefix pop differ by a
    bounded number of scans, and both honor the >=15 s exclusion."""
    rng = np.random.default_rng(0)
    n = 2000
    dt = 0.1
    ts = np.arange(n) * dt
    keys = _key_trace(rng, n)
    ref_pop, dbs = _drive(ts, keys)
    repo_pop = _repo_pop_times(ts)

    # the rebalance path must actually have run (buckets split), otherwise
    # this trace does not exercise the schedule it claims to test
    assert any(db.ranges[1] < 1000.0 for db in dbs), \
        "no bucket split happened — trace too easy"

    n_keys = ref_pop.__len__()
    assert n_keys > 0
    max_delay = 0
    n_compared = 0
    for (lv, i, seq), ref_at in ref_pop.items():
        # exclusion contract in the reference model: popped only when
        # >= min_elapse old (popBufferMax cutoff)
        assert ts[ref_at] - ts[i] >= MIN_ELAPSE - dt, (i, ref_at)
        # ...and by max_elapse + one wave period it MUST have popped
        assert ts[ref_at] - ts[i] <= MAX_ELAPSE + (WAVE_PERIOD + 1) * dt, \
            (i, ref_at)
        if repo_pop[i] >= 0:
            n_compared += 1
            max_delay = max(max_delay, abs(int(ref_at) - int(repo_pop[i])))
    assert n_compared > 0.8 * len(ref_pop)

    # repo-model contract: the searchable prefix never admits a <15 s key
    for i in range(n):
        if repo_pop[i] >= 0:
            assert ts[repo_pop[i]] - ts[i] >= MIN_ELAPSE - dt

    # THE divergence bound: the two models' searchability onsets differ by at
    # most the (max-min) elapse trigger band plus one wave period. At 10 Hz
    # that is <= 108 scans; the measured value on this trace is ~100 scans
    # (10 s trigger-phase offset), i.e. the wave stagger itself contributes
    # <= 8 scans and the rest is trigger phasing both models already share.
    bound = int((MAX_ELAPSE - MIN_ELAPSE) / dt) + WAVE_PERIOD
    assert max_delay <= bound, max_delay
    print("max searchable-onset divergence: %d scans (bound %d)"
          % (max_delay, bound))


def test_stagger_divergence_bounded_1hz():
    """Synthetic-benchmark rate (1 Hz): same bounds, coarser clock — the
    wave period dominates the band here, so this pins the stagger itself."""
    rng = np.random.default_rng(1)
    n = 400
    dt = 1.0
    ts = np.arange(n) * dt
    keys = _key_trace(rng, n)
    ref_pop, _ = _drive(ts, keys)
    repo_pop = _repo_pop_times(ts)

    max_delay = 0
    for (lv, i, seq), ref_at in ref_pop.items():
        assert ts[ref_at] - ts[i] >= MIN_ELAPSE - dt
        assert ts[ref_at] - ts[i] <= MAX_ELAPSE + (WAVE_PERIOD + 1) * dt
        if repo_pop[i] >= 0:
            max_delay = max(max_delay, abs(int(ref_at) - int(repo_pop[i])))
    bound = int((MAX_ELAPSE - MIN_ELAPSE) / dt) + WAVE_PERIOD
    assert max_delay <= bound, max_delay


def test_wave_visits_every_pair():
    """The triangle wave covers every adjacent bucket pair within one
    period, so no bucket's buffer can starve (contour_db.h:828-830)."""
    seen = {triangle_pair_index(i) for i in range(WAVE_PERIOD)}
    assert seen == set(range(NUM_BUCKETS - 1))


def test_ref_schedule_equal_sets_in_steady_state():
    """Once every key is older than max_elapse + wave period, the reference's
    searchable KEY SET equals the global-prefix model's set exactly — the
    divergence lives only in the onset band, never in steady state."""
    rng = np.random.default_rng(2)
    n = 600
    dt = 0.1
    ts = np.arange(n) * dt
    keys = _key_trace(rng, n, n_levels=1)
    ref_pop, dbs = _drive(ts, keys, n_levels=1)
    repo_pop = _repo_pop_times(ts)

    horizon = n - 1 - int((MAX_ELAPSE / dt)) - WAVE_PERIOD - 1
    ref_ids = {(i, seq) for (lv, i, seq) in ref_pop if i <= horizon}
    repo_ids = {(i, seq) for i in range(n)
                if 0 <= repo_pop[i] and i <= horizon
                for seq in range(len(keys[i][0]))}
    assert ref_ids == repo_ids


def test_rebuild_tiny_trees_size_diff_one():
    """Balance branch with to_move_mid == 0 (tree sizes differ by 1, both
    buffers due): the C++ reads sort_permu[sz1] out of bounds here (UB,
    contour_db.cpp:117-118); the replica defines it as unsplittable and pops
    both buckets. Regression for an IndexError in RefLayerDB.rebuild."""
    db = RefLayerDB(MIN_ELAPSE, MAX_ELAPSE)
    db.ranges[1] = 0.5                      # buckets 0:[-1000,0.5) 1:[0.5,1000)
    db.tree[0] = [(0.1 * i, ("a", i)) for i in range(5)]
    db.tree[1] = [(0.6 + 0.01 * i, ("b", i)) for i in range(4)]
    t = 100.0
    db.buf[0] = [(0.2, t - 30.0, ("c", 0))]
    db.buf[1] = [(0.7, t - 30.0, ("d", 0))]
    db.rebuild(0, t)                        # used to raise IndexError
    assert not db.buf[0] and not db.buf[1]  # both due buffers popped
    assert len(db.tree[0]) == 6 and len(db.tree[1]) == 5
    assert db.ranges[1] == 0.5              # nothing moved across the split
