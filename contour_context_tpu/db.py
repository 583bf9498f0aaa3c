"""ContourDB: device-resident descriptor store + one-dispatch query.

Replaces the reference's bucketed nanoflann kd-trees + sequential check cascade
(contour_db.h:54-845) with:

- a growing device-array store of ScanDesc rows (append = dynamic_update_slice
  with buffer donation, no host copies of history),
- brute-force masked top-k key search as one dispatch (the kd-tree + bucket
  fan-out of contour_db.cpp:319-379 returns the global top-k under a distance
  bound; dense top-k computes exactly that, a strict superset in recall),
- the temporal insertion delay (TreeBucket buffering, contour_db.h:102-143)
  modeled as a searchable prefix: keys of scan i become searchable once a pop
  is triggered (oldest unpopped ts <= t-max_elapse) and ts_i < t-min_elapse.
  The reference staggers pops per bucket by a few scans; the >=15 s exclusion
  window — the semantic contract used by gt labeling — is preserved exactly.
- ONE fused XLA dispatch per query: search -> stable hint compaction ->
  batched check cascade (ops/cascade.py) -> on-device sequential proposal
  merge (ops/candidate.py) -> tidy screens -> batched GMM init + fixed-iter
  LM refinement (ops/gmm.py) -> top-1.  The result is a tiny QueryRecord
  fetched with an async host copy, so the steady-state loop never blocks on
  the host<->device link.

A host-side replica of the reference's CandidateManager (contour_db.h:264-656)
is kept below as the readable spec; tests assert the fused device path matches
it hint-for-hint.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from contour_context_tpu.config import (
    DIST_BIN_LAYERS,
    LAYER_AREA_WEIGHTS,
    CandidateScoreEnsemble,
    PipelineConfig,
)
from contour_context_tpu.ops.cascade import CascadeResult, run_cascade
from contour_context_tpu.ops.candidate import (
    dynamic_pass_scan,
    dynamic_post_scan,
    merge_proposals,
    select_topk_stable,
    tidy_candidates,
)
from contour_context_tpu.ops.gmm import (
    GmmScan,
    gmm_from_desc,
    init_correlation,
    optimize_correlation,
)
from contour_context_tpu.types import ScanDesc

MAX_DIST_SQ = 1e6  # contour_db.h:30


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def _kq_dtype(cfg: PipelineConfig):
    """dtype of the maintained search-layout key copy: bfloat16 when
    cfg.cm.keys_bf16 (halves the city-scale search's HBM read; archived
    ScanDesc.keys stay exact f32 — see the config.py knob docs)."""
    return jnp.bfloat16 if cfg.cm.keys_bf16 else jnp.float32


def _keys_to_q_layout(keys, dtype=None):
    """(N, L, A, D) scan-major keys -> (L, D, N*A) search-layout copy.

    The search wants the row axis MINOR: with rows minor, the key distance
    is ten fused broadcast-FMA passes over contiguous N*A-element vectors
    (see _key_distances). Doing this transpose per query would cost a full
    extra pass over the store, larger than the distance itself — so
    ContourDB maintains
    the (L, D, capacity*A) copy INCREMENTALLY at append time (keys_q) and
    this helper exists for (re)derivation at load/merge time and for the
    compat wrappers that tests drive with scan-major keys. Values are pure
    copies (or a single rounding cast when `dtype` narrows): the maintained
    copy is bit-identical to the derived one.
    """
    N, L, A, D = keys.shape
    out = keys.transpose(1, 3, 0, 2).reshape(L, D, N * A)
    return out if dtype is None else out.astype(dtype)


def _append_impl(store: ScanDesc, keys_q, ts_store, state, desc: ScanDesc,
                 ts):
    """Append desc at row state[0]; state = (n, pop_ptr) int32 device scalars.

    The row index lives on device so the steady-state loop uploads nothing
    per scan beyond the point cloud.
    The single definition is shared by _append, _scan_step and
    _process_block so the three entry modes cannot fork append semantics.
    `keys_q` is the (L, D, capacity*A) search-layout key copy (see
    _keys_to_q_layout): the scan's keys land in it twice-transposed at
    columns [n*A, (n+1)*A) — an (L, D, A) block write, so the per-query
    layout transpose never happens.
    """
    n = state[0]
    new_store = jax.tree.map(
        lambda buf, x: jax.lax.dynamic_update_index_in_dim(buf, x, n, 0),
        store, desc)
    A = desc.keys.shape[1]
    new_keys_q = jax.lax.dynamic_update_slice(
        keys_q, desc.keys.transpose(0, 2, 1).astype(keys_q.dtype),
        (0, 0, n * A))
    new_ts = jax.lax.dynamic_update_index_in_dim(
        ts_store, jnp.asarray(ts, ts_store.dtype), n, 0)
    return new_store, new_keys_q, new_ts, state.at[0].add(1)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _append(store: ScanDesc, keys_q, ts_store, state, desc: ScanDesc, ts):
    return _append_impl(store, keys_q, ts_store, state, desc, ts)


@functools.partial(jax.jit, donate_argnums=0, static_argnames=("min_elapse", "max_elapse"))
def _update_window(state, ts_store, curr_ts, min_elapse: float,
                   max_elapse: float):
    """pushAndBalance temporal-window replica, fully on device.

    Pop triggers when the oldest unpopped scan is older than max_elapse; then
    every scan older than min_elapse becomes searchable (TreeBucket semantics,
    contour_db.h:102-143). Timestamps are monotone in a stream, so the new
    pop pointer is a masked count (see _update_window_impl below).
    """
    return _update_window_impl(state, ts_store, curr_ts, min_elapse, max_elapse)


def _key_distances(keys_q, q_keys, searchable_n, q_levels: Tuple[int, ...]):
    """Masked squared key distances, (Q, A, N*A), invalid rows at MAX_DIST_SQ.

    `keys_q` is the SEARCH-LAYOUT key store (L, D, N*A) — row axis minor
    (see _keys_to_q_layout; ContourDB maintains it at append time). With
    rows on the minor axis the distance is a direct squared-difference
    accumulated over the D=10 key dims: ten fused broadcast-FMA passes over
    contiguous N*A-element vectors, a pure streaming read of the store. The
    tempting alternatives both do more work:
    - |q|^2+|r|^2-2 q.r^T with the cross term as a batched matmul is a
      DEGENERATE matmul (M=6 anchors, K=10 dims), far too small for a
      matrix unit;
    - any formulation over the scan-major (N, L, A, D) store pays a
      layout transpose of the whole store first.
    Direct differencing is also numerically tighter than the norm-cross
    identity (no cancellation), matching the numpy oracle more closely.
    Masks: zero (invalid) keys on either side, and the temporal-window
    searchability prefix.
    """
    L, D, NA = keys_q.shape
    A = q_keys.shape[1]
    lv = jnp.array(q_levels, jnp.int32)
    lo, nq = q_levels[0], len(q_levels)
    if q_levels == tuple(range(lo, lo + nq)):
        kt = jax.lax.slice_in_dim(keys_q, lo, lo + nq, axis=0)
    else:
        kt = keys_q[lv]
    f32 = jnp.float32
    q = q_keys[lv]                                          # (Q, A, D)
    q_f = q.astype(f32)
    # bf16 keys (cfg.cm.keys_bf16) stream at half the HBM bytes and upcast
    # in-register inside the fused accumulation (no f32 copy)
    d2 = jnp.zeros((nq, A, NA), f32)
    for d in range(D):                                      # D=10, static
        diff = kt[:, d, :][:, None, :].astype(f32) - q_f[:, :, d][:, :, None]
        d2 = d2 + diff * diff
    row_valid = jnp.abs(kt.astype(f32)).sum(1) > 0          # (Q, N*A)
    scan_of_row = (jnp.arange(NA, dtype=jnp.int32) // A)[None]
    searchable = scan_of_row < searchable_n
    q_valid = jnp.abs(q_f).sum(-1) > 0                      # (Q, A)
    ok = row_valid[:, None, :] & searchable[:, None, :] & q_valid[..., None]
    return jnp.where(ok, d2, MAX_DIST_SQ), q_f


TOPK_BLOCK = 4096   # two-stage min-k block width (see _topk_min)
TOPK_TILE = 128     # tile-min-cover tile width (see _topk_min_cover)


def _topk_min_cover(d2m, k: int):
    """Exact min-k via the tile-min cover (the XLA twin of the Pallas
    search kernel's selection): per-TOPK_TILE-tile min — a pure reduce, no
    sort over the full row — then top-k tiles by (min, tile index), gather
    the k*TILE covered entries, and lexicographically sort by (value,
    column). Identical results to `-lax.top_k(-d2m, k)`.

    Exactness incl. tie order: suppose a global top-k element x = (v, c)
    lies in an UNselected tile t. Each of the k selected tiles has min < v,
    or min == v with tile index < t; either way its min element precedes x
    in (value asc, column asc) order (at equal value its column is lower,
    being in an earlier tile). That is k elements preceding x —
    contradiction, so the k selected tiles cover the global top-k. The
    lexicographic sort then reproduces lax.top_k's value-then-lower-index
    tie order among the covered entries. Padding (MAX_DIST_SQ at columns
    >= M) sorts after every real entry of equal value (higher column) and
    M >> k real entries exist, so padding is never selected.

    Callers must ensure k <= ceil(M / TOPK_TILE) (the cover needs k tiles)."""
    M = d2m.shape[-1]
    T = TOPK_TILE
    lead = d2m.shape[:-1]
    pad = (-M) % T
    if pad:
        d2m = jnp.pad(d2m, ((0, 0),) * (d2m.ndim - 1) + ((0, pad),),
                      constant_values=MAX_DIST_SQ)
    Bt = (M + pad) // T
    tmin = d2m.reshape(lead + (Bt, T)).min(axis=-1)
    _, tidx = jax.lax.top_k(-tmin, k)          # ties: lower tile index first
    cols = (tidx.astype(jnp.int32)[..., None] * T
            + jnp.arange(T, dtype=jnp.int32)).reshape(lead + (k * T,))
    vals = jnp.take_along_axis(d2m.reshape(lead + (Bt * T,)), cols, axis=-1)
    sv, sc = jax.lax.sort([vals, cols], dimension=-1, num_keys=2)
    return sv[..., :k], sc[..., :k]


def _search_cover2(keys_q, q_keys, searchable_n, q_levels: Tuple[int, ...],
                   k: int):
    """Tile-min-cover search WITHOUT materializing the (Q, A, N*A) distance
    matrix — the "cover2" strategy (ContourDBConfig.topk_strategy).

    The plain cover path (_key_distances + _topk_min_cover) must gather the
    covered entries FROM d2m, which forces XLA to materialize the full
    distance matrix in HBM (340 MB at 131k scans) just so ~6400 of its
    entries can be read back. Here stage 1 (masked distance + per-tile min)
    fuses into one reduction over the key store — the only full-size HBM
    read — and stage 2 gathers the k covering tiles' KEY COLUMNS (a few MB)
    and recomputes their masked distances exactly. Element-exact vs the
    cover path: the per-element FMA order is identical in both distance
    computations, the tile selection key (min, tile index) is identical, and
    the final lexicographic (value, column) sort is the same proof as
    _topk_min_cover's. Zero-padded columns (store pad, tile pad) carry zero
    keys -> row_valid False -> MAX_DIST_SQ, exactly like the cover path's
    constant padding.

    Returns (dist, idx, q_f32) with (dist, idx) as _topk_min would, plus the
    f32 query keys for the caller's distance-bound computation.
    Caller guarantees: N*A >= 4*TOPK_BLOCK, k <= (N*A)//TOPK_TILE."""
    L, D, NA = keys_q.shape
    A = q_keys.shape[1]
    lv = jnp.array(q_levels, jnp.int32)
    lo, nq = q_levels[0], len(q_levels)
    if q_levels == tuple(range(lo, lo + nq)):
        kt = jax.lax.slice_in_dim(keys_q, lo, lo + nq, axis=0)
    else:
        kt = keys_q[lv]
    f32 = jnp.float32
    q_f = q_keys[lv].astype(f32)                          # (nq, A, D)
    T = TOPK_TILE
    pad = (-NA) % T
    ktp = (jnp.pad(kt, ((0, 0), (0, 0), (0, pad))) if pad else kt)
    NAp = NA + pad
    Bt = NAp // T
    ktt = ktp.reshape(nq, D, Bt, T)
    d2 = jnp.zeros((nq, A, Bt, T), f32)
    for d in range(D):                                    # D=10, static
        diff = (ktt[:, d][:, None].astype(f32)
                - q_f[:, :, d][:, :, None, None])
        d2 = d2 + diff * diff
    row_valid = jnp.abs(ktt.astype(f32)).sum(1) > 0       # (nq, Bt, T)
    colid = jnp.arange(NAp, dtype=jnp.int32).reshape(Bt, T)
    col_ok = ((colid // A) < searchable_n) & (colid < NA)  # (Bt, T)
    q_valid = jnp.abs(q_f).sum(-1) > 0                    # (nq, A)
    ok = (row_valid[:, None] & col_ok[None, None]
          & q_valid[..., None, None])
    tmin = jnp.where(ok, d2, MAX_DIST_SQ).min(-1)         # (nq, A, Bt)
    _, tidx = jax.lax.top_k(-tmin, k)          # ties: lower tile index first
    cols = (tidx.astype(jnp.int32)[..., None] * T
            + jnp.arange(T, dtype=jnp.int32)).reshape(nq, A, k * T)
    # vmapped fancy-index gather: operand stays (D, NAp) per level — a
    # take_along_axis over broadcast operands materializes an (nq, D, A,
    # NAp) copy (~2 GB at 131k scans) and defeats the whole point of this
    # lowering
    ktg = jax.vmap(lambda kt_l, cols_l: kt_l[:, cols_l])(
        ktp, cols).astype(f32)                            # (nq, D, A, k*T)
    d2g = jnp.zeros((nq, A, k * T), f32)
    for d in range(D):
        diff = ktg[:, d] - q_f[:, :, d][:, :, None]
        d2g = d2g + diff * diff
    rv_g = jnp.abs(ktg).sum(1) > 0
    ok_g = (rv_g & ((cols // A) < searchable_n) & (cols < NA)
            & q_valid[..., None])
    vals = jnp.where(ok_g, d2g, MAX_DIST_SQ)
    sv, sc = jax.lax.sort([vals, cols], dimension=-1, num_keys=2)
    return sv[..., :k], sc[..., :k], q_f


def _topk_min(d2m, k: int, strategy: str = "block"):
    """Exact min-k over the last axis, ascending, ties by lower index —
    identical results to `-lax.top_k(-d2m, k)` at every size and strategy.

    For large rows the single-stage XLA TopK over the full (Q, A, N*A)
    distance matrix is the city-scale bottleneck (a sort-based lowering,
    many times the cost of reading the keys once), so
    rows >= 4*TOPK_BLOCK switch to an exact reduction chosen by `strategy`
    (ContourDBConfig.topk_strategy — both are exact, pick by measurement):

    - "block": per-TOPK_BLOCK-tile min-k, then min-k over the B*k block
      winners. Exactness incl. tie order: top_k breaks value ties by lower
      index, and the block-major flattening preserves global index order,
      so the stage-2 selection reproduces the single-stage choice
      element-for-element (ties within a block keep their stage-1 order;
      ties across blocks resolve by block order = global order). Padding
      (when M % TOPK_BLOCK != 0) uses MAX_DIST_SQ at indices >= M: real
      entries of equal value precede padding in tie order, and M >> k, so
      padding is never selected.
    - "cover": the tile-min cover (_topk_min_cover) — stage 1 is a pure
      min-reduce instead of a per-block sort.

    k > TOPK_BLOCK (e.g. range_search with cap > 4096) falls back to the
    single-stage path — stage 1 cannot return k winners from a narrower
    block, and XLA rejects top_k with k beyond the axis size. "cover"
    additionally requires k tiles to exist (k <= M/TOPK_TILE), else the
    block strategy is used."""
    M = d2m.shape[-1]
    if strategy == "cover2":    # the fused lowering lives in _search_cover2;
        strategy = "cover"      # d2m-shaped callers get its cover twin
    if M < 4 * TOPK_BLOCK or k > TOPK_BLOCK:
        neg, idx = jax.lax.top_k(-d2m, k)
        return -neg, idx.astype(jnp.int32)
    if strategy == "cover" and k <= M // TOPK_TILE:
        return _topk_min_cover(d2m, k)
    C = TOPK_BLOCK
    pad = (-M) % C
    if pad:
        d2m = jnp.pad(d2m, ((0, 0),) * (d2m.ndim - 1) + ((0, pad),),
                      constant_values=MAX_DIST_SQ)
    B = (M + pad) // C
    lead = d2m.shape[:-1]
    neg1, idx1 = jax.lax.top_k(-d2m.reshape(lead + (B, C)), k)
    base = jnp.arange(B, dtype=jnp.int32) * C
    gidx1 = (idx1.astype(jnp.int32) + base[..., None]).reshape(lead + (B * k,))
    neg2, idx2 = jax.lax.top_k(neg1.reshape(lead + (B * k,)), k)
    idx = jnp.take_along_axis(gidx1, idx2, axis=-1)
    return -neg2, idx


def _search_impl(keys_q, q_keys, searchable_n, q_levels: Tuple[int, ...],
                 nnk: int, strategy: str = "block"):
    """keys_q (L, D, N*A) search layout; q_keys (L, A, 10) -> hits per
    (q_level, seq).

    Returns (gidx, seq_src, dist, valid) each (Q, A, nnk), hits sorted by
    ascending distance, bounded by the per-key adaptive distance upper bound
    (contour_db.h:733-749) and by searchability.
    """
    A = q_keys.shape[1]
    NA = keys_q.shape[2]
    nnk = min(nnk, NA)      # tiny DBs have fewer rows than the k bound
    if (strategy == "cover2" and NA >= 4 * TOPK_BLOCK
            and nnk <= NA // TOPK_TILE):
        dist, idx, q = _search_cover2(keys_q, q_keys, searchable_n,
                                      q_levels, nnk)
    else:
        d2m, q = _key_distances(keys_q, q_keys, searchable_n, q_levels)
        dist, idx = _topk_min(d2m, nnk, strategy)           # ascending distance
    k0, k1, k2 = q[..., 0], q[..., 1], q[..., 2]
    ub = (jnp.maximum((k0 - k0 * 0.8) ** 2, (k0 - k0 / 0.8) ** 2)
          + jnp.maximum((k1 - k1 * 0.8) ** 2, (k1 - k1 / 0.8) ** 2)
          + jnp.maximum((k2 - k2 * 0.8 * 0.75) ** 2, (k2 - k2 / (0.8 * 0.75)) ** 2))
    valid = dist < jnp.minimum(ub[..., None], MAX_DIST_SQ)
    gidx = idx // A
    seq_src = idx % A
    return gidx.astype(jnp.int32), seq_src.astype(jnp.int32), dist, valid


@functools.partial(jax.jit, static_argnames=("q_levels", "nnk", "strategy"))
def _search(db_keys, q_keys, searchable_n, q_levels: Tuple[int, ...], nnk: int,
            strategy: str = "block"):
    """Compat wrapper over _search_impl taking the scan-major (N, L, A, D)
    keys — derives the search layout in-graph (the per-dispatch transpose
    production avoids; fine for tests / the host spec path)."""
    return _search_impl(_keys_to_q_layout(db_keys), q_keys, searchable_n,
                        q_levels, nnk, strategy)


@functools.partial(jax.jit, static_argnames=("q_levels", "cap", "strategy"))
def _range_search(db_keys, q_keys, searchable_n, max_dist_sq,
                  q_levels: Tuple[int, ...], cap: int,
                  strategy: str = "block", keys_q=None):
    """layerRangeSearch analog (contour_db.h:204-216, contour_db.cpp:405-424):
    every searchable key within max_dist_sq of any query (q_level, anchor)
    key, ascending distance, capped at `cap` rows.

    Returns ONE packed (cap+1, 5) f32 buffer (single host fetch): row 0
    cols 0-1 hold the total in-range count split as (count // 2^20,
    count % 2^20) so it stays exact beyond f32's 2^24 integer range on
    city-scale maps; rows 1.. are (gidx, level, seq_src, seq_tgt, dist_sq),
    dist_sq == -1 when unused.
    """
    kq = keys_q if keys_q is not None else _keys_to_q_layout(db_keys)
    d2m, _ = _key_distances(kq, q_keys, searchable_n, q_levels)
    Q, A, R = d2m.shape
    n_rows_per_level = A                           # anchors per (scan, level)
    flat = d2m.reshape(-1)
    # radii beyond the invalid-row sentinel are meaningless (d2m is capped
    # there), and clamping keeps the mask value strictly out of range below
    max_dist_sq = jnp.minimum(max_dist_sq, MAX_DIST_SQ * (1 - 1e-6))
    inr = flat < max_dist_sq
    n_total = jnp.sum(inr).astype(jnp.int32)
    # _topk_min == stable ascending argsort[:cap] (ties by index), without
    # the full 14M-element sort at city scale; padded/masked slots carry
    # value >= max_dist_sq, so validity comes from the selected VALUES
    vals, order = _topk_min(jnp.where(inr, flat, MAX_DIST_SQ)[None],
                            min(cap, flat.size), strategy)
    vals, order = vals[0], jnp.minimum(order[0], flat.size - 1)
    if order.shape[0] < cap:    # tiny DBs: fewer rows than the cap
        pad_k = cap - order.shape[0]
        vals = jnp.pad(vals, (0, pad_k), constant_values=MAX_DIST_SQ)
        order = jnp.pad(order, (0, pad_k))
    sel_valid = vals < max_dist_sq
    lv = jnp.array(q_levels, jnp.float32)
    qi = order // (A * R)
    rem = order % (A * R)
    ai = rem // R
    ri = rem % R
    hits = jnp.stack([
        (ri // n_rows_per_level).astype(jnp.float32),   # gidx
        lv[qi],                                         # level
        (ri % n_rows_per_level).astype(jnp.float32),    # seq_src
        ai.astype(jnp.float32),                         # seq_tgt
        jnp.take(flat, order)], axis=1)
    hits = jnp.where(sel_valid[:, None], hits, -1.0)
    head = jnp.zeros((1, 5), jnp.float32)
    head = head.at[0, 0].set((n_total // (1 << 20)).astype(jnp.float32))
    head = head.at[0, 1].set((n_total % (1 << 20)).astype(jnp.float32))
    return jnp.concatenate([head, hits], axis=0)


def _select_hints(valid_f, dist_f, HC: int):
    """Pick the hints fed to the check cascade (cap = max_check_cands).

    The reference processes every hit sequentially (contour_db.h:764-771);
    the fused step pads to a fixed hint count HC. Under overflow (dense
    self-similar maps) keep the HC nearest-by-key-distance hits instead of
    the positional head — dropping the far tail loses strictly less recall
    than dropping whole levels/anchors; see select_topk_stable for the
    under-cap reference-order parity guarantee."""
    return select_topk_stable(dist_f, valid_f, HC)


def _tab_from(desc_like, gidx=None):
    """Build the (…, 4, J, ·) check-3 stats table from ScanDesc(-like) arrays.

    If gidx is given the leading index is per-hint; otherwise the query's own
    table (broadcast later). Levels rows = DIST_BIN_LAYERS; J = 10 seqs.

    SUPERSEDED on the hot path by the archived pre-packed ScanDesc.tab12
    (ops/descriptor.pack_tab12): nine per-chunk store gathers + a stack
    became one row gather. Kept for diagnostics/scripts.
    """
    lv = jnp.array(DIST_BIN_LAYERS, jnp.int32)
    J = 10

    if gidx is None:
        sl = lambda a: a[lv, :J]
    else:
        sl = lambda a: a[gidx][:, lv, :J]
    return dict(
        cnt=sl(desc_like.cnt).astype(jnp.float32),
        eig=sl(desc_like.eig_vals),
        h=sl(desc_like.vol3_mean),
        comr=sl(desc_like.com_r),
        mean=sl(desc_like.mean),
        vec1=sl(desc_like.eig_vecs)[..., :, 1],
        ecc=sl(desc_like.ecc_feat),
        perc=sl(desc_like.cont_perc),
        ok=sl(desc_like.valid),
    )


def _anchor12(g):
    """Anchor stat channels (cnt, eig, h, comr) of packed tab12 rows."""
    return dict(cnt=g[..., 0],
                eig=jnp.stack([g[..., 1], g[..., 2]], axis=-1),
                h=g[..., 3], comr=g[..., 4])


def _check1_impl(store: ScanDesc, query: ScanDesc, gidx, level, seq_src,
                 seq_tgt, hint_valid, cont_sim):
    """Check 1 (anchor ContourView::checkSim, contour.h:278-329) for every
    hint: the prefilter of the chunked cascade (config.check1_prefilter).
    Reads the anchor stat channels from the packed tab12 rows — ONE store
    gather per hint instead of four (bit-identical values: tab12 channels
    0-4 are pure copies of cnt/eig_vals/vol3_mean/com_r at the anchor's
    (level, seq); q_levels are validated to lie in DIST_BIN_LAYERS and
    anchor seqs < A=6 < J=10, so the slice always covers them)."""
    from contour_context_tpu.ops.cascade import check_sim_batched

    H = gidx.shape[0]
    gi = jnp.where(hint_valid, gidx, 0)
    li = jnp.clip(level - 1, 0, store.tab12.shape[1] - 1)
    js = jnp.clip(seq_src, 0, store.tab12.shape[2] - 1)
    jt = jnp.clip(seq_tgt, 0, query.tab12.shape[1] - 1)
    s = _anchor12(store.tab12[gi][jnp.arange(H), li, js])
    t = _anchor12(query.tab12[li, jt])
    return hint_valid & check_sim_batched(
        s["cnt"], s["eig"], s["h"], s["comr"],
        t["cnt"], t["eig"], t["h"], t["comr"], cont_sim)


def _gather_and_cascade_impl(store: ScanDesc, query: ScanDesc,
                             gidx, level, seq_src, seq_tgt, hint_valid,
                             thres_lb: CandidateScoreEnsemble, cont_sim,
                             p_pot: int | None = None):
    H = gidx.shape[0]
    hv = hint_valid
    gi = jnp.where(hv, gidx, 0)
    lvl = jnp.clip(level, 0, store.nei_valid.shape[1] - 1)
    ss = jnp.clip(seq_src, 0, store.nei_valid.shape[2] - 1)
    st = jnp.clip(seq_tgt, 0, query.nei_valid.shape[1] - 1)

    def at_src(a):
        return a[gi, lvl, ss]

    def at_tgt(a):
        return a[lvl, st]

    src_nei = dict(valid=at_src(store.nei_valid), level=at_src(store.nei_level),
                   seq=at_src(store.nei_seq), bit=at_src(store.nei_bit),
                   theta=at_src(store.nei_theta))
    tgt_nei = dict(valid=at_tgt(query.nei_valid), level=at_tgt(query.nei_level),
                   seq=at_tgt(query.nei_seq), bit=at_tgt(query.nei_bit),
                   theta=at_tgt(query.nei_theta))
    # check-3 stats: ONE row gather of the archived pre-packed table
    # (ScanDesc.tab12) per side — replaces the nine-array _tab_from gather +
    # per-chunk pack
    src_tab12 = store.tab12[gi]
    # the anchor stat channels (check 1) are slices of the rows just
    # gathered — no extra store reads (cnt/eig_vals/vol3_mean/com_r stay
    # out of the query executable entirely; tab12 channels are exact copies)
    li = jnp.clip(level - 1, 0, src_tab12.shape[1] - 1)
    js = jnp.clip(seq_src, 0, src_tab12.shape[2] - 1)
    jt = jnp.clip(seq_tgt, 0, query.tab12.shape[1] - 1)
    src_anchor = _anchor12(src_tab12[jnp.arange(H), li, js])
    tgt_anchor = _anchor12(query.tab12[li, jt])
    return run_cascade(src_anchor, src_nei, src_tab12, tgt_anchor, tgt_nei,
                       query.tab12, hv, level, seq_src, seq_tgt,
                       thres_lb, cont_sim, p_pot)


@functools.partial(jax.jit, static_argnames=("thres_lb", "cont_sim", "p_pot"))
def _gather_and_cascade(store: ScanDesc, query: ScanDesc,
                        gidx, level, seq_src, seq_tgt, hint_valid,
                        thres_lb: CandidateScoreEnsemble, cont_sim,
                        p_pot: int | None = None):
    return _gather_and_cascade_impl(store, query, gidx, level, seq_src,
                                    seq_tgt, hint_valid, thres_lb, cont_sim,
                                    p_pot)


def _cascade_chunked(store: ScanDesc, query: ScanDesc, gidx, level, seq_src,
                     seq_tgt, hv, n_valid, thres_lb, cont_sim, chunk: int,
                     p_pot: int | None = None):
    """Chunked check cascade: ONE compiled cascade at width W, applied to
    ceil(n_valid / W) chunks of the compacted hint rows by a dynamic-trip
    while_loop.

    Every op in run_cascade is independent per hint row, so partitioning the
    rows into chunks returns bit-identical per-hint results; _select_hints
    orders the n_valid selected rows first, so only the first ceil(n_valid/W)
    chunks contain live hints. Unprocessed rows keep zeros, which downstream
    already treats as non-hints (pass* False, pair_valid False) — identical
    to what the cascade itself computes for hv=False rows.

    Why this shape: the cascade's cost is flat in its padded hint axis, and
    KITTI-like streams average ~18 valid hits/scan against the
    max_check_cands pad; the synthetic bench world runs ~50-270. Chunking
    makes the cost proportional to ceil(n_valid/W) while compiling the
    cascade body ONCE at width W — a 4-8x smaller graph than the
    full-width compile, which also cuts every query graph's compile time.

    The last chunk's start is clamped (dynamic_slice semantics), so chunks
    may overlap when W does not divide HC — overlapping rows are simply
    recomputed with identical results before being rewritten.
    """
    HC = gidx.shape[0]
    W = min(chunk, HC) if chunk > 0 else HC
    if W >= HC:
        return _gather_and_cascade_impl(store, query, gidx, level, seq_src,
                                        seq_tgt, hv, thres_lb, cont_sim,
                                        p_pot)
    n_chunks = -(-HC // W)

    # the while_loop below round-trips its carry every iteration, and a
    # 16-leaf CascadeResult carry costs 16 dynamic_update_slices + 16 carry
    # writes per chunk of pure loop machinery. Pack the result into TWO f32
    # arrays for the loop (ints
    # < 2^24 and bools ride f32 exactly) and unpack once afterwards.
    def run_chunk(start):
        sl = lambda a: lax.dynamic_slice_in_dim(a, start, W, axis=0)
        r = _gather_and_cascade_impl(
            store, query, sl(gidx), sl(level), sl(seq_src), sl(seq_tgt),
            sl(hv), thres_lb, cont_sim, p_pot)
        f32 = lambda a: a.astype(jnp.float32)
        scal = jnp.stack([
            f32(r.pass1), f32(r.pass2), f32(r.pass3),
            f32(r.ovlp_sum), f32(r.ovlp_max_one), f32(r.in_ang_rng),
            f32(r.i_indiv_sim), f32(r.i_orie_sim),
            f32(r.pot_overflow), f32(r.win_overflow),
            r.T_delta[:, 0], r.T_delta[:, 1], r.T_delta[:, 2]], axis=1)
        pair = jnp.stack([
            f32(r.pair_valid), f32(r.pair_level), f32(r.pair_seq_src),
            f32(r.pair_seq_tgt), r.pair_area_perc], axis=2)
        return scal, pair                       # (W, 13), (W, P, 5)

    P = jax.eval_shape(run_chunk, jnp.int32(0))[1].shape[1]
    out0 = (jnp.zeros((HC, 13), jnp.float32),
            jnp.zeros((HC, P, 5), jnp.float32))
    nc = jnp.minimum((n_valid + (W - 1)) // W, n_chunks)

    def body(carry):
        i, (scal, pair) = carry
        start = jnp.minimum(i * W, HC - W)
        s, p = run_chunk(start)
        scal = lax.dynamic_update_slice_in_dim(scal, s, start, axis=0)
        pair = lax.dynamic_update_slice_in_dim(pair, p, start, axis=0)
        return i + 1, (scal, pair)

    _, (scal, pair) = lax.while_loop(lambda c: c[0] < nc, body,
                                     (jnp.int32(0), out0))
    i32 = lambda a: a.astype(jnp.int32)
    return CascadeResult(
        pass1=scal[:, 0] > 0.5, pass2=scal[:, 1] > 0.5, pass3=scal[:, 2] > 0.5,
        ovlp_sum=i32(scal[:, 3]), ovlp_max_one=i32(scal[:, 4]),
        in_ang_rng=i32(scal[:, 5]), i_indiv_sim=i32(scal[:, 6]),
        i_orie_sim=i32(scal[:, 7]),
        pair_valid=pair[:, :, 0] > 0.5, pair_level=i32(pair[:, :, 1]),
        pair_seq_src=i32(pair[:, :, 2]), pair_seq_tgt=i32(pair[:, :, 3]),
        pair_area_perc=pair[:, :, 4],
        T_delta=scal[:, 10:13],
        pot_overflow=scal[:, 8] > 0.5, win_overflow=scal[:, 9] > 0.5,
    )


def _gather_gmm_impl(store: ScanDesc, gidx, levels: Tuple[int, ...],
                     max_k: int) -> GmmScan:
    """Candidate-side GmmScan gather: ONE flat row of the archived
    pre-packed table (ScanDesc.gmm_pack) per candidate. Bit-identical to
    gathering mean/manual_cov/cnt/eig_vals/gmm_mask (the pack stores pure
    copies of exactly those slices) but reads 4 KB/candidate instead of
    touching five multi-GB leaves — the five-leaf gather made the query's
    "init" cost grow with the store capacity."""
    G, K = len(levels), max_k
    assert store.gmm_pack.shape[-1] == G * K * 8, (
        "gmm_pack was built with a different GMMOptConfig "
        f"({store.gmm_pack.shape[-1]} != {G}*{K}*8)")
    rows = store.gmm_pack[gidx].reshape(gidx.shape[0], G, K, 8)
    return GmmScan(
        mus=rows[..., 0:2],
        covs=rows[..., 2:6].reshape(gidx.shape[0], G, K, 2, 2),
        ws=rows[..., 6],
        majax=rows[..., 7],
        auto_corr=store.auto_corr[gidx],
    )


@functools.partial(jax.jit, static_argnames=("levels", "max_k"))
def _gather_gmm(store: ScanDesc, gidx, levels: Tuple[int, ...],
                max_k: int) -> GmmScan:
    return _gather_gmm_impl(store, gidx, levels, max_k)


# ---------------------------------------------------------------------------
# the fused per-query device step
# ---------------------------------------------------------------------------

class QueryRecord(NamedTuple):
    """Per-query result record. On device this travels as ONE packed
    (RECORD_WIDTH,) f32 vector (see pack/unpack below): every fetched buffer
    costs a host round trip, so the record is a single buffer, and blocks of
    records are stacked on device before the one host copy per drain block."""
    found: jnp.ndarray        # () bool
    gidx: jnp.ndarray         # () int32 best candidate's store row
    corr: jnp.ndarray         # () f32 refined correlation
    T: jnp.ndarray            # (3,) f32 (x, y, theta) BEV delta
    n_hints: jnp.ndarray      # () int32 valid key hits
    aft1: jnp.ndarray         # () int32 survivors of check 1 (cand_aft_check1)
    aft2: jnp.ndarray         # () int32 survivors of check 2
    aft3: jnp.ndarray         # () int32 survivors of check 3
    n_cand: jnp.ndarray       # () int32 candidate poses after merging
    overflow_hints: jnp.ndarray  # () int32 valid hits beyond max_check_cands
    overflow_pass: jnp.ndarray   # () int32 passing hints beyond merge budget
    overflow_cand: jnp.ndarray   # () int32 hints dropped, candidate table full
    overflow_pot: jnp.ndarray    # () int32 check-1-surviving hints whose
    #                                 bit-adjacent pair pool exceeded
    #                                 cascade.P_POT (window truncated) —
    #                                 survivors only: a check-1 failure can
    #                                 never contribute a pair
    overflow_win: jnp.ndarray    # () int32 check-1-surviving hints whose
    #                                 consensus window exceeded cascade.P_MAX-1
    #                                 (pairs dropped)
    overflow_pix: jnp.ndarray    # () int32 query ring-key pixels beyond
    #                                 cfg.cm.pix_pool (weakest-weight dropped)
    overflow_gmm: jnp.ndarray    # () int32 query 95%-area GMM ellipses beyond
    #                                 max_gmm_ellipses (dropped from corr)


RECORD_WIDTH = 18   # packed record floats (all used; ints exact in f32 < 2^24)


def _pack_record(rec: QueryRecord) -> jnp.ndarray:
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return jnp.concatenate([
        jnp.stack([f32(rec.found), f32(rec.gidx), f32(rec.corr)]),
        rec.T.astype(jnp.float32),
        jnp.stack([f32(rec.n_hints), f32(rec.aft1), f32(rec.aft2),
                   f32(rec.aft3), f32(rec.n_cand), f32(rec.overflow_hints),
                   f32(rec.overflow_pass), f32(rec.overflow_cand),
                   f32(rec.overflow_pot), f32(rec.overflow_win),
                   f32(rec.overflow_pix), f32(rec.overflow_gmm)]),
    ])


def _unpack_record(v: np.ndarray) -> QueryRecord:
    v = np.asarray(v)
    return QueryRecord(
        found=bool(v[0] > 0.5), gidx=int(v[1]), corr=float(v[2]),
        T=v[3:6].astype(np.float64), n_hints=int(v[6]), aft1=int(v[7]),
        aft2=int(v[8]), aft3=int(v[9]), n_cand=int(v[10]),
        overflow_hints=int(v[11]), overflow_pass=int(v[12]),
        overflow_cand=int(v[13]), overflow_pot=int(v[14]),
        overflow_win=int(v[15]), overflow_pix=int(v[16]),
        overflow_gmm=int(v[17]))


def _query_step_impl(store: ScanDesc, query: ScanDesc, searchable_n,
                     pcfg: PipelineConfig, keys_q=None,
                     depth: Optional[str] = None):
    """queryRangedKNN (contour_db.h:698-811) as one fused computation.

    Rows below `searchable_n` are searchable. Everything (store, query) is
    device-resident, so a query costs zero host->device transfers.
    `keys_q` is the maintained (L, D, N*A) search-layout key copy
    (_keys_to_q_layout) — when omitted it is derived in-graph from
    store.keys (bit-identical values, but pays the per-dispatch layout
    transpose production avoids; the compat path for tests).

    `depth` (trace-time) truncates the computation for stage attribution
    (scripts/headline_split_bench.py): "search" / "hints" / "check1" /
    "cascade" / "merge" / "init" return a scalar probe of the live outputs
    at that depth instead of the packed record, so the split benchmarks time
    the EXACT production graph prefixes — a hand-copied replica drifted from
    the shipping path twice in r3/r4. None (production) returns the record.
    """
    cfg = pcfg
    q_levels = tuple(cfg.db.q_levels)
    nnk = cfg.db.nnk
    N = store.keys.shape[0]
    if keys_q is None:
        keys_q = _keys_to_q_layout(store.keys)

    gidx, seq_src, dist, valid = _search_impl(
        keys_q, query.keys, searchable_n, q_levels, nnk,
        cfg.db.topk_strategy)
    if depth == "search":
        return (dist.sum() + gidx.sum() + valid.sum()).astype(jnp.float32)
    Q, A, K = gidx.shape
    Hfull = Q * A * K
    lv = jnp.array(q_levels, jnp.int32)
    level_f = jnp.broadcast_to(lv[:, None, None], (Q, A, K)).reshape(-1)
    seq_tgt_f = jnp.broadcast_to(
        jnp.arange(A, dtype=jnp.int32)[None, :, None], (Q, A, K)).reshape(-1)
    gidx_f = gidx.reshape(-1)
    seq_src_f = seq_src.reshape(-1)
    valid_f = valid.reshape(-1)

    HC = min(cfg.db.max_check_cands, Hfull)
    perm, hv, n_valid, overflow_hints = _select_hints(
        valid_f, dist.reshape(-1), HC)
    g_h, l_h = gidx_f[perm], level_f[perm]
    ss_h, st_h = seq_src_f[perm], seq_tgt_f[perm]
    if depth == "hints":
        return (perm.sum() + g_h.sum() + n_valid).astype(jnp.float32)

    # check-1 prefilter (config.check1_prefilter): compute the cheap anchor
    # checkSim for ALL selected hints, then compact its survivors — in hint
    # order, so the merge still processes passing hints in the reference's
    # sequential order — and run the chunked cascade over ceil(aft1/W)
    # chunks instead of ceil(n_valid/W). Bit-identical records: pass2/3
    # require pass1, so the skipped rows contribute nothing downstream
    # (pinned by tests/test_fused_step.py's prefilter A/B). Headline-world
    # funnel: ~617 hints/scan but far fewer check-1 survivors, so this
    # removes most cascade chunks. The overflow_pot/win counters then count
    # check-1 SURVIVORS only — exactly the rows whose pool truncation could
    # affect results (a check-1 failure can never contribute a pair).
    chunkw = cfg.db.cascade_chunk
    use_prefilter = (cfg.db.check1_prefilter and 0 < chunkw < HC)
    if use_prefilter:
        pass1_all = _check1_impl(store, query, g_h, l_h, ss_h, st_h, hv,
                                 cfg.db.cont_sim)
        aft1 = jnp.sum(pass1_all).astype(jnp.int32)
        pos = jnp.arange(HC, dtype=jnp.float32)
        perm2, hv_run, n_run, _ = select_topk_stable(pos, pass1_all, HC)
        g_h, l_h = g_h[perm2], l_h[perm2]
        ss_h, st_h = ss_h[perm2], st_h[perm2]
    else:
        aft1 = None
        hv_run, n_run = hv, n_valid
    if depth == "check1":
        return (n_run + hv_run.sum() + g_h.sum()).astype(jnp.float32)

    res = _cascade_chunked(
        store, query, g_h, l_h, ss_h, st_h, hv_run, n_run,
        cfg.thres_lb, cfg.db.cont_sim, chunkw, cfg.db.p_pot)
    if depth == "cascade":
        return (res.T_delta.sum() + res.pass3.sum()
                + res.pair_area_perc.sum()).astype(jnp.float32)

    if cfg.db.dynamic_thres:
        # DYNAMIC_THRES=1: sequential re-gating with rising bars
        pass2_d, pass3_d = dynamic_pass_scan(
            res.pass1, res.ovlp_sum, res.ovlp_max_one, res.in_ang_rng,
            res.i_indiv_sim, res.i_orie_sim, cfg.thres_lb, cfg.thres_ub)
    else:
        pass2_d, pass3_d = res.pass2, res.pass3

    st = merge_proposals(
        pass3_d, g_h, res.T_delta, res.pair_valid, res.pair_level,
        res.pair_seq_src, res.pair_seq_tgt, res.pair_area_perc,
        n_cand_max=cfg.db.max_cand_poses, n_pass_max=cfg.db.max_pass_hints)
    if depth == "merge":
        return (st.prop_T.sum() + st.n_cand).astype(jnp.float32)

    tidy = tidy_candidates(
        st, cfg.thres_lb.sim_post.area_perc, cfg.thres_lb.sim_post.neg_est_dist,
        cfg.cm.n_row, cfg.cm.n_col, cfg.cm.reso_row, cfg.cm.reso_col)
    T_sel = tidy.T_sel

    # batched GMM init correlation (screen 3/3 of tidyUpCandidates)
    cg = jnp.clip(st.cand_gidx, 0, N - 1)
    src_gmm = _gather_gmm_impl(store, cg, tuple(cfg.gmm.levels),
                               cfg.gmm.max_gmm_ellipses)
    tgt_gmm = gmm_from_desc(query, cfg.gmm)
    corr0, selp = init_correlation(src_gmm, tgt_gmm, T_sel,
                                   scale=cfg.gmm.cov_dilate_scale)
    if depth == "init":
        return (corr0.sum() + T_sel.sum()).astype(jnp.float32)
    if cfg.db.dynamic_thres:
        keep = dynamic_post_scan(tidy.in_use, tidy.area, tidy.neg_d, corr0,
                                 cfg.thres_lb.sim_post, cfg.thres_ub.sim_post)
    else:
        keep = tidy.alive & (corr0 >= cfg.thres_lb.sim_post.correlation)

    # fineOptimize (contour_db.h:604-648): LM-refine the top max_fine_opt
    C = st.cand_gidx.shape[0]
    F = min(cfg.db.max_fine_opt, C)
    rank = jnp.where(keep, corr0, -jnp.inf)
    topv, topi = jax.lax.top_k(rank, F)
    valid_fine = jnp.isfinite(topv)
    src_f = jax.tree.map(lambda a: a[topi], src_gmm)
    corr_f, T_f = optimize_correlation(
        src_f, tgt_gmm, T_sel[topi], selp[topi],
        scale=cfg.gmm.cov_dilate_scale, iters=cfg.gmm.gn_iters)
    corr_fm = jnp.where(valid_fine, corr_f, -jnp.inf)
    best = jnp.argmax(corr_fm)
    found = jnp.any(valid_fine)

    return _pack_record(QueryRecord(
        found=found,
        gidx=jnp.where(found, st.cand_gidx[topi[best]], -1).astype(jnp.int32),
        corr=jnp.where(found, corr_fm[best], 0.0).astype(jnp.float32),
        T=T_f[best].astype(jnp.float32),
        n_hints=n_valid,
        aft1=(jnp.sum(res.pass1).astype(jnp.int32) if aft1 is None else aft1),
        aft2=jnp.sum(pass2_d).astype(jnp.int32),
        aft3=jnp.sum(pass3_d).astype(jnp.int32),
        n_cand=st.n_cand,
        overflow_hints=overflow_hints.astype(jnp.int32),
        overflow_pass=st.overflow_pass,
        overflow_cand=st.overflow_cand,
        # pot/win truncation is counted over check-1 SURVIVORS in both the
        # prefilter and the plain path (pass1 == hv_run there): a check-1
        # failure can never contribute a constellation pair, so its pool
        # truncation cannot affect results — and the two paths then emit
        # bit-identical records (tests/test_fused_query.py prefilter A/B)
        overflow_pot=jnp.sum(res.pot_overflow & res.pass1).astype(jnp.int32),
        overflow_win=jnp.sum(res.win_overflow & res.pass1).astype(jnp.int32),
        overflow_pix=jnp.asarray(query.pix_overflow, jnp.int32),
        overflow_gmm=jnp.asarray(query.gmm_overflow, jnp.int32),
    ))


@functools.partial(jax.jit, static_argnames=("pcfg",))
def _query_step(store: ScanDesc, query: ScanDesc, state,
                pcfg: PipelineConfig, keys_q=None):
    return _query_step_impl(store, query, state[1], pcfg, keys_q)


def _desc_step_impl(store: ScanDesc, keys_q, ts_store, state, recs_store,
                    desc: ScanDesc, ts, pcfg: PipelineConfig):
    """query -> record-ring write -> append -> window update for ONE
    already-built descriptor (the sequential tail of _scan_step_impl; the
    chain paths prebuild descriptors in vmapped sub-batches and feed them
    here one by one)."""
    rec = _query_step_impl(store, desc, state[1], pcfg, keys_q)
    recs_store = jax.lax.dynamic_update_slice(
        recs_store, rec[None].astype(recs_store.dtype), (state[0], 0))
    store, keys_q, ts_store, state = _append_impl(store, keys_q, ts_store,
                                                  state, desc, ts)
    tb = pcfg.db.tb
    state = _update_window_impl(state, ts_store, ts, tb.min_elapse,
                                tb.max_elapse)
    return store, keys_q, ts_store, state, recs_store, rec


def _scan_step_impl(store: ScanDesc, keys_q, ts_store, state, recs_store,
                    points, ts, pcfg: PipelineConfig):
    """Body of the fused per-scan streaming step (see _scan_step)."""
    from contour_context_tpu.ops.descriptor import build_descriptor

    desc = build_descriptor(points, pcfg.cm, pcfg.gmm)
    return _desc_step_impl(store, keys_q, ts_store, state, recs_store,
                           desc, ts, pcfg)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4),
                   static_argnames=("pcfg",))
def _scan_step(store: ScanDesc, keys_q, ts_store, state, recs_store, points,
               ts, pcfg: PipelineConfig):
    """The FULLY fused per-scan streaming step, one dispatch per scan:

        points -> descriptor build -> query (window state BEFORE this scan's
        push, the reference's query -> addScan -> pushAndBalance order,
        batch_bin_test.cpp:105-238) -> append -> temporal-window update.

    vs the 4-dispatch path (build / query / append / window) this removes
    three dispatches per scan, and with them their host overhead.

    The packed record is also written into `recs_store` at this scan's row
    (a donated (capacity, RECORD_WIDTH) ring), so an entire stream's results
    can later leave the device as ONE contiguous buffer fetch instead of one
    fetch per scan (see drain_handles).
    Returns (store', keys_q', ts_store', state', recs_store', packed record).
    """
    return _scan_step_impl(store, keys_q, ts_store, state, recs_store,
                           points, ts, pcfg)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4),
                   static_argnames=("pcfg",))
def _step_chain(store: ScanDesc, keys_q, ts_store, state, recs_store,
                points_k, ts_k, pcfg: PipelineConfig):
    """K sequential fused per-scan steps in ONE dispatch (lax.scan over
    _scan_step_impl).

    Unlike _process_block (which batches the B queries and relies on the
    >= min_elapse temporal-exclusion theorem for intra-block independence),
    this replays the per-scan step EXACTLY — query_i sees every append and
    window update of scans < i regardless of timestamp spacing — so it is
    valid for arbitrary (even sub-second) timestamp gaps. Throughput mode
    for sequential semantics; also a timing primitive: K steps amortize the
    dispatch + sync overhead of a single call, so differencing two K values
    isolates device time (bench.py headline).

    Descriptor builds are hoisted OUT of the sequential scan and vmapped in
    sub-batches of DESC_BATCH scans (the build depends only on the points,
    never on DB state, so batching is exact): one batched sort/scan pipeline
    per 16 scans replaces 16 small ones, amortizing per-op overhead of the
    descriptor stage's many small kernels. The query/append scan below
    stays strictly sequential and bit-identical.

    Returns (store', keys_q', ts_store', state', recs_store', records (K, W)).
    """
    descs = _build_descs_chunked(points_k, pcfg, batch=DESC_BATCH)

    def body(carry, x):
        desc, t = x
        store, keys_q, ts_store, state, recs_store, rec = _desc_step_impl(
            *carry, desc, t, pcfg)
        return (store, keys_q, ts_store, state, recs_store), rec

    (store, keys_q, ts_store, state, recs_store), recs = jax.lax.scan(
        body, (store, keys_q, ts_store, state, recs_store), (descs, ts_k))
    return store, keys_q, ts_store, state, recs_store, recs


DESC_BATCH = 16     # default for ContourDBConfig.desc_batch (see config.py)


def _build_descs_chunked(points_k, pcfg: PipelineConfig,
                         batch=None) -> ScanDesc:
    """vmap build_descriptor over K scans in sub-batches of
    pcfg.db.desc_batch.

    Sub-batching (a traced Python loop over ceil(K/B) vmapped calls, last
    chunk possibly narrower) bounds the batched component_tables membership
    temporaries to ~0.5 GB instead of K/B x that, while still giving every
    sort/scan/reduce_window a batch axis. The stacked ScanDesc output is
    small (~39 KB/scan). The batch size is a measured lowering knob
    (config.ContourDBConfig.desc_batch, scripts/desc_batch_ab.py) — but it
    is CONTEXT-dependent: desc_batch=1 wins inside the per-scan sequential
    dyn chain (builds fuse into the step), while BATCHED contexts (block
    steps, the legacy scan lowering, staging) must keep vmapped sub-batches
    — 16 sequential single builds + a 25-leaf tree concat inside a block
    chain cost far more than one vmapped build. Such callers pass
    `batch=DESC_BATCH` explicitly."""
    from contour_context_tpu.ops.descriptor import build_descriptor

    K = points_k.shape[0]
    B = max(1, pcfg.db.desc_batch if batch is None else batch)
    build_b = jax.vmap(lambda p: build_descriptor(p, pcfg.cm, pcfg.gmm))
    if K <= B:
        return build_b(points_k)
    chunks = [build_b(points_k[i:i + B])
              for i in range(0, K, B)]
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *chunks)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4),
                   static_argnames=("pcfg",))
def _step_chain_dyn(store: ScanDesc, keys_q, ts_store, state, recs_store,
                    points_k, ts_k, k, pcfg: PipelineConfig):
    """_step_chain with a DYNAMIC chain length `k` (device int32 scalar):
    runs the first k rows of `points_k`/`ts_k` through the fused per-scan
    step in ONE dispatch (lax.fori_loop -> while_loop, trip count a runtime
    value). ONE executable serves every k <= points_k.shape[0], so the
    chained-dispatch differencing methodology (bench.py) measures the SAME
    compiled code at both chain lengths — and pays one XLA compile instead
    of one per length. Records land in the recs_store ring (rows
    state[0]..state[0]+k-1); the (K, W) stacked-records output of
    _step_chain is not produced.

    Like _step_chain, descriptor builds are vmapped: a fori_loop over
    k // DESC_BATCH full chunks (each chunk dynamic-slices 16 point rows,
    builds their descriptors in one vmapped call, then replays 16 exact
    sequential query/append steps), plus a per-scan tail loop for the
    k % DESC_BATCH remainder. Builds happen for exactly the first k rows,
    so chained-dispatch differencing at two k values attributes build cost
    to precisely the scans between them (bench.py headline honesty).

    Returns (store', keys_q', ts_store', state', recs_store').
    """
    B = min(max(1, pcfg.db.desc_batch), int(points_k.shape[0]))
    if B == 1:
        # per-scan builds: the chunk machinery is pure overhead at B=1
        def tail_body1(i, carry):
            pts = jax.lax.dynamic_index_in_dim(points_k, i, keepdims=False)
            out = _scan_step_impl(*carry, pts, ts_k[i], pcfg)
            return out[:5]
        return jax.lax.fori_loop(
            0, k, tail_body1,
            (store, keys_q, ts_store, state, recs_store))

    def chunk_body(c, carry):
        store, keys_q, ts_store, state, recs_store = carry
        pts_b = jax.lax.dynamic_slice_in_dim(points_k, c * B, B, axis=0)
        ts_b = jax.lax.dynamic_slice_in_dim(ts_k, c * B, B, axis=0)
        descs = _build_descs_chunked(pts_b, pcfg)

        def body(carry2, x):
            desc, t = x
            out = _desc_step_impl(*carry2, desc, t, pcfg)
            return out[:5], None

        carry, _ = jax.lax.scan(
            body, (store, keys_q, ts_store, state, recs_store), (descs, ts_b))
        return carry

    carry = jax.lax.fori_loop(
        0, k // B, chunk_body,
        (store, keys_q, ts_store, state, recs_store))

    def tail_body(i, carry):
        store, keys_q, ts_store, state, recs_store = carry
        pts = jax.lax.dynamic_index_in_dim(points_k, i, keepdims=False)
        store, keys_q, ts_store, state, recs_store, _rec = _scan_step_impl(
            store, keys_q, ts_store, state, recs_store, pts, ts_k[i], pcfg)
        return (store, keys_q, ts_store, state, recs_store)

    return jax.lax.fori_loop((k // B) * B, k, tail_body, carry)


def _update_window_impl(state, ts_store, curr_ts, min_elapse, max_elapse):
    n, pop_ptr = state[0], state[1]
    idx = jnp.arange(ts_store.shape[0], dtype=jnp.int32)
    oldest = ts_store[jnp.clip(pop_ptr, 0, ts_store.shape[0] - 1)]
    trigger = (pop_ptr < n) & (oldest <= curr_ts - max_elapse)
    k = jnp.sum((idx < n) & (ts_store < curr_ts - min_elapse)).astype(jnp.int32)
    new_pop = jnp.where(trigger, jnp.maximum(k, pop_ptr), pop_ptr)
    return state.at[1].set(new_pop)


@functools.partial(jax.jit, static_argnames=("pcfg",))
def _localize_block(store: ScanDesc, state, points_b, pcfg: PipelineConfig,
                    keys_q=None):
    """Map-serving mode: B point clouds -> B packed records, ONE dispatch,
    WITHOUT mutating the store (descriptor build vmapped + batched queries
    against the frozen searchable prefix). No reference analog — the
    reference couples query and insert in one streaming loop; a device
    serving a prebuilt map wants the decoupled, batched form."""
    from contour_context_tpu.ops.descriptor import build_descriptor

    if keys_q is None:
        keys_q = _keys_to_q_layout(store.keys)
    descs = jax.vmap(lambda p: build_descriptor(p, pcfg.cm, pcfg.gmm))(points_b)
    return jax.vmap(
        lambda q: _query_step_impl(store, q, state[1], pcfg, keys_q))(descs)


def _process_block_impl(store: ScanDesc, keys_q, ts_store, state, recs_store,
                        descs: ScanDesc, ts_b, pcfg: PipelineConfig):
    """Body of the batched block step (see _process_block)."""
    B = ts_b.shape[0]
    tb = pcfg.db.tb
    row0 = state[0]

    def append_one(carry, x):
        desc, t = x
        return _append_impl(*carry, desc, t), None

    (store, keys_q, ts_store, state), _ = jax.lax.scan(
        append_one, (store, keys_q, ts_store, state), (descs, ts_b))

    # per-query window state: query b sees pushes of t_0..t_{b-1}
    def push_one(carry, t_prev):
        new = _update_window_impl(carry, ts_store, t_prev,
                                  tb.min_elapse, tb.max_elapse)
        return new, carry[1]

    state, searchable_b = jax.lax.scan(push_one, state, ts_b)

    recs = jax.vmap(
        lambda q, sn: _query_step_impl(store, q, sn, pcfg, keys_q),
        in_axes=(0, 0))(descs, searchable_b)
    recs_store = jax.lax.dynamic_update_slice(
        recs_store, recs.astype(recs_store.dtype), (row0, 0))
    return store, keys_q, ts_store, state, recs_store, recs


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4),
                   static_argnames=("pcfg",))
def _process_block(store: ScanDesc, keys_q, ts_store, state, recs_store,
                   descs: ScanDesc, ts_b, pcfg: PipelineConfig):
    """Batched throughput mode: append + query a block of B scans at once.

    EXACT sequential parity: the reference's per-scan order is
    query_i (window after pushes <= i-1) -> add_i -> push(t_i); scans are
    appended first (their timestamps exceed every query's min_elapse cut, so
    they are invisible to the block's searches — the >=15 s exclusion window
    makes intra-block independence a theorem, SURVEY.md §2.6), then each
    query's searchable prefix is replayed with a scan over the window updates,
    and the B queries run under vmap.

    Returns (store', keys_q', ts_store', state', recs_store', records
    (B, RECORD_WIDTH)); the records are also written into the `recs_store`
    ring at the block's rows (see _scan_step).
    """
    return _process_block_impl(store, keys_q, ts_store, state, recs_store,
                               descs, ts_b, pcfg)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4),
                   static_argnames=("pcfg",))
def _block_chain(store: ScanDesc, keys_q, ts_store, state, recs_store,
                 descs_nb: ScanDesc, ts_nb, pcfg: PipelineConfig):
    """NB sequential block steps in ONE dispatch (lax.scan over
    _process_block_impl); `descs_nb` is (NB, B)-stacked, `ts_nb` (NB, B).

    The timing primitive for block throughput (see _step_chain):
    differencing two NB values isolates per-block device time. Returns
    (..., records (NB, B, W))."""
    def body(carry, x):
        descs, ts_b = x
        store, keys_q, ts_store, state, recs_store, recs = _process_block_impl(
            *carry, descs, ts_b, pcfg)
        return (store, keys_q, ts_store, state, recs_store), recs

    (store, keys_q, ts_store, state, recs_store), recs = jax.lax.scan(
        body, (store, keys_q, ts_store, state, recs_store), (descs_nb, ts_nb))
    return store, keys_q, ts_store, state, recs_store, recs


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4),
                   static_argnames=("pcfg",))
def _block_chain_pts(store: ScanDesc, keys_q, ts_store, state, recs_store,
                     points_nb, ts_nb, pcfg: PipelineConfig):
    """_block_chain with the descriptor build IN-DISPATCH: `points_nb` is
    (NB, B, max_points, 4) raw point clouds; each chain step builds its
    block's B descriptors (vmapped) and then runs the batched block step.

    This is the FULL block-mode pipeline in one timing primitive —
    differencing two NB values yields per-block device time INCLUDING the
    descriptor build (the reference's 11 ms is 82% build,
    log/timing_cont2_paper.txt:34, so a build-free block number is not
    comparable to it). Returns (..., records (NB, B, W))."""
    def body(carry, x):
        pts_b, ts_b = x
        descs = _build_descs_chunked(pts_b, pcfg, batch=DESC_BATCH)
        out = _process_block_impl(*carry, descs, ts_b, pcfg)
        return out[:5], out[5]

    (store, keys_q, ts_store, state, recs_store), recs = jax.lax.scan(
        body, (store, keys_q, ts_store, state, recs_store),
        (points_nb, ts_nb))
    return store, keys_q, ts_store, state, recs_store, recs


class QueryHandle:
    """Deferred query result: a packed device record vector not yet fetched.

    Fetch one with `get()` (one host round trip) or many with
    `drain_handles()` (ONE contiguous ring-buffer copy for a whole stream —
    the steady-state pattern: one transfer instead of one per scan). `row` is the scan's row in the DB's device record ring when the
    handle came from the fused streaming path (step_async); None for
    standalone queries (query_async), which drain by per-buffer fetch."""

    __slots__ = ("rec", "row", "_db", "_host")

    def __init__(self, rec: jnp.ndarray, db: "ContourDB",
                 row: Optional[int] = None):
        self.rec = rec          # (RECORD_WIDTH,) f32 on device
        self.row = row
        self._db = db
        self._host: Optional[QueryRecord] = None

    def _finish(self, vec) -> Optional[Tuple[int, float, np.ndarray]]:
        rec = _unpack_record(vec)
        self._host = rec
        self._db._accumulate_counters(rec)
        if not rec.found:
            return None
        return rec.gidx, rec.corr, rec.T

    def get(self) -> Optional[Tuple[int, float, np.ndarray]]:
        if self._host is not None:
            rec = self._host
            return (rec.gidx, rec.corr, rec.T) if rec.found else None
        return self._finish(jax.device_get(self.rec))


class BlockHandle:
    """Deferred results of a processed block: (B, RECORD_WIDTH) on device.

    `counters="serving"` (map-serving queries) routes the records into the
    DB's separate `serving_counters` so serving traffic cannot skew the
    stream's overflow/cascade diagnostics yet stays diagnosable itself."""

    __slots__ = ("recs", "row0", "_db", "_host", "_counters")

    def __init__(self, recs: jnp.ndarray, db: "ContourDB",
                 counters: str = "counters", row0: Optional[int] = None):
        self.recs = recs
        self.row0 = row0    # first ring row (fused append path) or None
        self._db = db
        self._host = None
        self._counters = counters

    def _finish(self, mat) -> None:
        out = []
        for row in np.asarray(mat):
            rec = _unpack_record(row)
            self._db._accumulate_counters(rec, self._counters)
            out.append((rec.gidx, rec.corr, rec.T) if rec.found else None)
        self._host = out

    def get(self) -> list:
        """Fetch the block's results: one host copy, list of per-scan
        (gidx, corr, T3) or None, in scan order."""
        if self._host is None:
            self._finish(jax.device_get(self.recs))
        return self._host


def _fetch_rings(ring_handles) -> dict:
    """Fetch each distinct DB's record ring ONCE; returns {id(db): ndarray}.

    One contiguous (capacity, RECORD_WIDTH) buffer copy per DB replaces a
    per-handle fetch (one transfer each) or an eager jnp.stack of the
    handles (an arity-N compile) — the whole-ring copy is one transfer."""
    rings = {}
    for h in ring_handles:
        key = id(h._db)
        if key not in rings:
            rings[key] = np.asarray(jax.device_get(h._db.recs_store))
    return rings


def drain_block_handles(handles) -> None:
    """Fetch many BlockHandles' records efficiently.

    Ring-backed blocks (process_block_async) read their rows from ONE
    record-ring copy per DB; standalone blocks (localize_block_async) fetch
    their own (B, RECORD_WIDTH) buffer in one batched device_get. Handles
    already fetched keep their cached results. After this, h.get() is free."""
    live = [h for h in handles if h is not None and h._host is None]
    if not live:
        return
    ring = [h for h in live
            if h.row0 is not None and h._db.recs_store is not None]
    rest = [h for h in live
            if h.row0 is None or h._db.recs_store is None]
    if ring:
        rings = _fetch_rings(ring)
        for h in ring:
            B = int(h.recs.shape[0])
            h._finish(rings[id(h._db)][h.row0:h.row0 + B])
    if rest:
        # ONE device_get over the list: every copy is issued async up front,
        # then awaited together — no compiles, latencies overlap
        mats = jax.device_get([h.recs for h in rest])
        for h, mat in zip(rest, mats):
            h._finish(mat)


def drain_handles(handles) -> list:
    """Fetch a stream of QueryHandles' results with ONE ring-buffer copy.

    Handles from the fused streaming path (step_async) carry their DB row;
    their records live in the DB's device record ring, which is fetched ONCE
    per DB as a single contiguous buffer (per-buffer fetches cost one
    transfer each; eager stacks an arity-N compile).
    Standalone query_async handles fall back to one batched device_get.

    Returns a list of per-handle results (None or (gidx, corr, T3)), in order.
    None entries in `handles` pass through (queries against an empty DB);
    handles already fetched via get() reuse their cached record (their
    counters were accumulated then — re-finishing would double-count)."""
    live = [h for h in handles if h is not None and h._host is None]
    if live:
        ring = [h for h in live
                if h.row is not None and h._db.recs_store is not None]
        rest = [h for h in live
                if h.row is None or h._db.recs_store is None]
        if ring:
            rings = _fetch_rings(ring)
            for h in ring:
                h._finish(rings[id(h._db)][h.row])
        if rest:
            mats = jax.device_get([h.rec for h in rest])
            for h, vec in zip(rest, mats):
                h._finish(np.asarray(vec))
    return [None if h is None else h.get() for h in handles]


def _stream_savez(path: str, scalars: dict, store: ScanDesc,
                  since: int, n: int, chunk_bytes: int) -> None:
    """Write an npz (np.load-compatible) with the store leaves streamed from
    device in row blocks of <= chunk_bytes — the save never materializes a
    whole leaf on host, and no single D2H transfer exceeds the block size.

    DERIVED leaves (tab12, gmm_pack — recomputed unconditionally by
    load_chain) are skipped: load_chain zero-fills missing members and
    rebuilds them, so persisting the bytes (~6 KB/scan) would be dead
    weight in every checkpoint (r4 advisor finding)."""
    import zipfile

    from numpy.lib import format as npf

    skip = {ScanDesc._fields.index("tab12"),
            ScanDesc._fields.index("gmm_pack")}
    rows = n - since
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        import io

        for name, val in scalars.items():
            buf = io.BytesIO()
            np.save(buf, np.asarray(val))
            zf.writestr(name + ".npy", buf.getvalue())
        for i, leaf in enumerate(jax.tree.leaves(store)):
            if i in skip:
                continue
            row_bytes = max(1, int(np.prod(leaf.shape[1:])) * leaf.dtype.itemsize)
            step = max(1, chunk_bytes // row_bytes)
            header = {
                "descr": npf.dtype_to_descr(np.dtype(leaf.dtype)),
                "fortran_order": False,
                "shape": (rows,) + tuple(leaf.shape[1:]),
            }
            with zf.open(f"store_{i}.npy", "w", force_zip64=True) as f:
                npf.write_array_header_2_0(f, header)
                for s in range(since, n, step):
                    block = np.asarray(jax.device_get(leaf[s:min(s + step, n)]))
                    f.write(np.ascontiguousarray(block).tobytes())


# ---------------------------------------------------------------------------
# host-side CandidateManager (readable spec replica of contour_db.h:264-656;
# the device path above is tested against it)
# ---------------------------------------------------------------------------

@dataclass
class AnchorProp:
    T: np.ndarray                      # (3,) x, y, theta
    constell: dict                     # {(lev, ss, st): perc} first-insert wins
    vote_cnt: int
    area_perc: float = 0.0
    correlation: float = 0.0


@dataclass
class CandidatePose:
    gidx: int
    props: List[AnchorProp] = field(default_factory=list)
    corr_init: float = 0.0
    sel: Optional[object] = None

    def add_proposal(self, T: np.ndarray, pairs, percs):
        """addProposal (contour_db.h:286-338): greedy merge within (2 m, 0.3 rad)."""
        for p in self.props:
            # delta = T_prop^-1 * T_i
            c, s = math.cos(T[2]), math.sin(T[2])
            dx, dy = p.T[0] - T[0], p.T[1] - T[1]
            tx = c * dx + s * dy
            ty = -s * dx + c * dy
            dth = p.T[2] - T[2]
            dth = (dth + math.pi) % (2 * math.pi) - math.pi
            if math.hypot(tx, ty) < 2.0 and abs(dth) < 0.3:
                for pr, pc in zip(pairs, percs):
                    p.constell.setdefault(pr, pc)
                w1, w2 = p.vote_cnt, len(pairs)
                p.vote_cnt = w1 + w2
                trans = (np.array(p.T[:2]) * w1 + np.array(T[:2]) * w2) / (w1 + w2)
                diff = T[2] - p.T[2]
                if diff < 0:
                    diff += 2 * math.pi
                if diff > math.pi:
                    diff -= 2 * math.pi
                ang = diff * w2 / (w1 + w2) + p.T[2]
                p.T = np.array([trans[0], trans[1], ang])
                return
        if len(self.props) > 3:
            return
        self.props.append(AnchorProp(np.asarray(T, np.float64).copy(),
                                     {pr: pc for pr, pc in zip(pairs, percs)},
                                     len(pairs)))


class HostCandidateManager:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.order: List[int] = []         # gidx in first-seen order
        self.by_gidx = {}

    def add_passing_hint(self, gidx: int, T: np.ndarray, pairs, percs):
        cand = self.by_gidx.get(gidx)
        if cand is None:
            cand = CandidatePose(gidx)
            self.by_gidx[gidx] = cand
            self.order.append(gidx)
        cand.add_proposal(T, pairs, percs)

    def tidy_stats(self):
        """Per-candidate best-proposal selection + stats (tidyUpCandidates
        loop head, contour_db.h:503-545). Returns [(cand, area, neg_d), ...]
        in first-seen order; screening is applied by the caller (screens use
        rising bars under DYNAMIC_THRES)."""
        cfg = self.cfg
        out = []
        for gidx in self.order:
            cand = self.by_gidx[gidx]
            idx_sel = 0
            for i, p in enumerate(cand.props):
                lev_perc = {}
                for (lev, ss, st), perc in p.constell.items():
                    lev_perc[lev] = lev_perc.get(lev, 0.0) + perc
                p.area_perc = sum(
                    LAYER_AREA_WEIGHTS[j] * lev_perc.get(DIST_BIN_LAYERS[j], 0.0)
                    for j in range(len(DIST_BIN_LAYERS)))
                if p.vote_cnt > cand.props[idx_sel].vote_cnt:
                    idx_sel = i
            cand.props[0], cand.props[idx_sel] = cand.props[idx_sel], cand.props[0]

            # distance censor in the sensor frame (getEstSensTF, correlation.h:287-296)
            T = cand.props[0].T
            nr, nc = cfg.cm.n_row, cfg.cm.n_col
            ox = nr / 2 - 0.5
            oy = nc / 2 - 0.5
            c, s = math.cos(T[2]), math.sin(T[2])
            tx = c * ox - s * oy + T[0] - ox
            ty = s * ox + c * oy + T[1] - oy
            neg_d = -math.hypot(tx * cfg.cm.reso_row, ty * cfg.cm.reso_col)
            out.append((cand, cand.props[0].area_perc, neg_d))
        return out


# ---------------------------------------------------------------------------
# the DB itself
# ---------------------------------------------------------------------------

class ContourDB:
    """Top-level database (reference ContourDB, contour_db.h:658-845)."""

    def __init__(self, cfg: PipelineConfig, capacity: int = 8192):
        self.cfg = cfg
        self.capacity = capacity
        self.n = 0                # host mirror of state[0]
        self.store: Optional[ScanDesc] = None
        # (L, D, capacity*A) search-layout key copy, maintained at append
        # time (see _keys_to_q_layout — the per-query transpose it avoids is
        # the city-scale search bottleneck); always bit-identical to
        # _keys_to_q_layout(store.keys)
        self.keys_q = None
        self.ts_store = None      # (capacity,) f32 device timestamps
        self.state = None         # (2,) i32 device (n, pop_ptr/searchable_n)
        # (capacity, RECORD_WIDTH) f32 device ring of per-scan query records
        # (fused stream + block paths write it; drain_handles fetches it as
        # ONE contiguous buffer at stream end)
        self.recs_store = None
        self.ts: List[float] = []
        self.seq_of_gidx: List[int] = []
        self.max_fine = cfg.db.max_fine_opt
        self.gmm_pad = 32
        # check-cascade survivor counters (contour_db.h:356-359); map-serving
        # queries (localize_block_async) accumulate into the separate set so
        # neither traffic class hides the other's cap saturation
        self.counters = self._zero_counters()
        self.serving_counters = self._zero_counters()

    @staticmethod
    def _zero_counters() -> dict:
        return dict(n_hints=0, cand_aft_check1=0, cand_aft_check2=0,
                    cand_aft_check3=0, overflow_hints=0,
                    overflow_pass=0, overflow_cand=0, overflow_pot=0,
                    overflow_win=0, overflow_pix=0, overflow_gmm=0)

    def _accumulate_counters(self, rec, which: str = "counters") -> None:
        c = getattr(self, which)
        c["n_hints"] += int(rec.n_hints)
        c["cand_aft_check1"] += int(rec.aft1)
        c["cand_aft_check2"] += int(rec.aft2)
        c["cand_aft_check3"] += int(rec.aft3)
        c["overflow_hints"] += int(rec.overflow_hints)
        c["overflow_pass"] += int(rec.overflow_pass)
        c["overflow_cand"] += int(rec.overflow_cand)
        c["overflow_pot"] += int(rec.overflow_pot)
        c["overflow_win"] += int(rec.overflow_win)
        c["overflow_pix"] += int(rec.overflow_pix)
        c["overflow_gmm"] += int(rec.overflow_gmm)

    # -- maintenance ------------------------------------------------------

    @property
    def searchable_n(self) -> int:
        """Host view of the device window state (synchronizing; debug only)."""
        if self.state is None:
            return 0
        return int(jax.device_get(self.state)[1])

    def _grow(self, new_capacity: int) -> None:
        """Re-allocate the store to a larger capacity (device-side pad).

        Doubling amortizes the copy; the searchable prefix, timestamps and
        window state carry over unchanged. NOTE: triggers recompilation of
        the query/append graphs for the new shape — prefer sizing `capacity`
        up front for latency-critical streams."""
        assert new_capacity > self.capacity
        pad = new_capacity - self.capacity
        self.store = jax.tree.map(
            lambda a: jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]), self.store)
        L, D, _na = self.keys_q.shape
        A = self.store.keys.shape[2]
        self.keys_q = jnp.concatenate(
            [self.keys_q, jnp.zeros((L, D, pad * A), self.keys_q.dtype)],
            axis=2)
        self.ts_store = jnp.concatenate(
            [self.ts_store, jnp.zeros((pad,), jnp.float32)])
        if self.recs_store is not None:
            self.recs_store = jnp.concatenate(
                [self.recs_store,
                 jnp.zeros((pad, RECORD_WIDTH), jnp.float32)])
        self.capacity = new_capacity

    def _ensure_capacity(self, need: int) -> None:
        if self.store is not None and self.n + need > self.capacity:
            self._grow(max(2 * self.capacity, self.n + need))

    def _init_store(self, desc: Optional[ScanDesc] = None) -> None:
        """Allocate the device store. Shapes come from `desc` when given,
        else from an eval_shape of the descriptor builder (no compute)."""
        if desc is None:
            from contour_context_tpu.ops.descriptor import build_descriptor

            desc = jax.eval_shape(
                lambda p: build_descriptor(p, self.cfg.cm, self.cfg.gmm),
                jax.ShapeDtypeStruct((self.cfg.cm.max_points, 4), jnp.float32))
        self.store = jax.tree.map(
            lambda x: jnp.zeros((self.capacity,) + x.shape, x.dtype), desc)
        L, A, D = desc.keys.shape
        self.keys_q = jnp.zeros((L, D, self.capacity * A),
                                _kq_dtype(self.cfg))
        self.ts_store = jnp.zeros((self.capacity,), jnp.float32)
        self.state = jnp.zeros((2,), jnp.int32)

    def step_async(self, points, seq: int, ts) -> QueryHandle:
        """ONE fused dispatch per scan: descriptor build + query + append +
        temporal-window update (reference per-scan order: queryRangedKNN ->
        addScan -> pushAndBalance, batch_bin_test.cpp:105-238).

        `points` is the (max_points, 4) payload (f32, or the int16 q16 wire
        format); `ts` may be a host float or a device scalar shipped with the
        payload. The returned QueryHandle's record reflects the DB state
        BEFORE this scan was appended — exact parity with the unfused
        query_async/add_scan/push_and_balance sequence (test_fused_query)."""
        if self.store is None:
            self._init_store()
        self._ensure_capacity(1)
        assert self.n < self.capacity, "DB capacity exceeded"
        if self.recs_store is None:
            self.recs_store = jnp.zeros((self.capacity, RECORD_WIDTH),
                                        jnp.float32)
        row = self.n
        (self.store, self.keys_q, self.ts_store, self.state, self.recs_store,
         rec) = _scan_step(self.store, self.keys_q, self.ts_store, self.state,
                           self.recs_store, points, ts, self.cfg)
        if isinstance(ts, (int, float, np.floating)):
            self.ts.append(float(ts))
        self.seq_of_gidx.append(seq)
        self.n += 1
        return QueryHandle(rec, self, row=row)

    def add_scan(self, desc: ScanDesc, seq: int, ts):
        """Append a scan. `ts` may be a host float (convenience) or a device
        scalar shipped with the scan payload (the zero-upload prod path)."""
        if self.store is None:
            self._init_store(desc)
        self._ensure_capacity(1)
        assert self.n < self.capacity, "DB capacity exceeded"
        self.store, self.keys_q, self.ts_store, self.state = _append(
            self.store, self.keys_q, self.ts_store, self.state, desc, ts)
        if isinstance(ts, (int, float, np.floating)):
            self.ts.append(float(ts))
        self.seq_of_gidx.append(seq)
        self.n += 1

    def push_and_balance(self, curr_ts):
        """Pop the buffer once the oldest unpopped scan exceeds max_elapse;
        everything older than min_elapse becomes searchable. Device-side."""
        tb = self.cfg.db.tb
        if self.state is None:
            return
        self.state = _update_window(self.state, self.ts_store, curr_ts,
                                    tb.min_elapse, tb.max_elapse)

    # -- checkpoint / resume ------------------------------------------------
    # The reference has no persistence (SURVEY.md §5: the DB is rebuilt by
    # replaying the sequence); device arrays make it trivial. save() fetches
    # device data, so a stream saves after its epoch, not inside it.

    def save(self, path: str, since: int = 0,
             chunk_bytes: int = 256 << 20) -> None:
        """Serialize rows [since:n] + window state + metadata to .npz.

        `since > 0` writes a DELTA checkpoint holding only the rows appended
        after a previous save — O(new rows) instead of an O(N) rewrite of a
        multi-GB city-scale store. Restore a base + deltas chain with
        `load_chain`; each file records its `since` so contiguity is
        verifiable. A full save is the `since=0` special case.

        The store leaves are STREAMED: device rows are fetched in blocks of
        <= `chunk_bytes` and written straight into the zip member, so neither
        host memory nor a single device->host transfer ever holds more than one
        block — a 131k-scan city store (~5 GB) saves at bounded memory
        instead of one multi-GB fetch (r1 weak #6)."""
        assert self.store is not None, "empty DB"
        n = self.n
        assert 0 <= since <= n, (since, n)
        state = np.asarray(jax.device_get(self.state))
        ts_store = np.asarray(jax.device_get(self.ts_store))[since:n]
        # the host f64 list is authoritative when populated (host-scalar ts
        # path): absolute epoch-scale stamps (~1.7e9 s) quantize by ~100 s in
        # the f32 ts_store; fall back to ts_store only on the device-resident
        # upload path where no host copy exists
        ts_f64 = (np.asarray(self.ts[since:n], np.float64)
                  if len(self.ts) == n else ts_store.astype(np.float64))
        scalars = dict(
            n=n, since=since, capacity=self.capacity, state=state,
            ts_store=ts_store,
            seq_of_gidx=np.asarray(self.seq_of_gidx[since:], np.int64),
            ts=ts_f64,
            counters=np.asarray([self.counters[k] for k in sorted(self.counters)],
                                np.int64),
            counter_keys=np.asarray(sorted(self.counters)))
        _stream_savez(path, scalars, self.store, since, n, chunk_bytes)

    @classmethod
    def load(cls, path: str, cfg: PipelineConfig,
             capacity: Optional[int] = None) -> "ContourDB":
        """Restore a DB checkpoint; capacity may be grown on load."""
        return cls.load_chain([path], cfg, capacity=capacity)

    @classmethod
    def load_chain(cls, paths: List[str], cfg: PipelineConfig,
                   capacity: Optional[int] = None) -> "ContourDB":
        """Restore a base checkpoint + delta chain (save(path, since=k)).

        Files must be contiguous: the first has since=0, each next file's
        `since` equals the previous file's row count `n`. Window state,
        counters and capacity come from the LAST file (the newest snapshot
        of the stream)."""
        zs = [np.load(p) for p in paths]
        sinces = [int(z["since"]) if "since" in z.files else 0 for z in zs]
        ns = [int(z["n"]) for z in zs]
        assert sinces[0] == 0, "first file of a chain must be a full save"
        for k in range(1, len(zs)):
            assert sinces[k] == ns[k - 1], (
                f"chain gap: {paths[k]} starts at row {sinces[k]}, previous "
                f"file ends at {ns[k - 1]}")
        n = ns[-1]
        cap = capacity or max(int(zs[-1]["capacity"]), n)
        assert cap >= n, "capacity smaller than stored rows"
        db = cls(cfg, capacity=cap)
        # migrate old checkpoints: leaves saved by position, so fields ADDED
        # at the end of ScanDesc (e.g. pix_overflow) zero-fill when missing,
        # and pre-compaction dtypes cast to what build_descriptor emits today
        # (a mismatch would fail the first append after resume)
        from contour_context_tpu.ops.descriptor import build_descriptor

        current = jax.eval_shape(
            lambda p: build_descriptor(p, cfg.cm, cfg.gmm),
            jax.ShapeDtypeStruct((cfg.cm.max_points, 4), jnp.float32))
        cur_leaves = jax.tree.leaves(current)
        leaves = []
        for i in range(len(ScanDesc._fields)):
            parts = [z[f"store_{i}"] if f"store_{i}" in z.files
                     else np.zeros((e - s,) + cur_leaves[i].shape,
                                   cur_leaves[i].dtype)
                     for z, s, e in zip(zs, sinces, ns)]
            leaves.append(np.concatenate(parts, axis=0) if len(parts) > 1
                          else parts[0])
        treedef = jax.tree.structure(ScanDesc(*ScanDesc._fields))
        host_store = jax.tree.unflatten(treedef, leaves)
        db.store = jax.tree.map(
            lambda a, cur: jnp.zeros((cap,) + a.shape[1:], cur.dtype)
            .at[:n].set(a.astype(cur.dtype)),
            host_store, current)
        # the search-layout copy is derived, not persisted (checkpoints stay
        # format-compatible); one transpose (+ optional bf16 cast) at load
        db.keys_q = _keys_to_q_layout(db.store.keys, _kq_dtype(cfg))
        # tab12/gmm_pack are derived from the other fields and NOT persisted
        # (saves skip the leaves; pre-r5 files that do carry them are
        # overwritten): recompute reproduces build_descriptor's packed
        # values bit-exactly (tests/test_checkpoint.py)
        from contour_context_tpu.ops.descriptor import gmm_pack_of, tab12_of

        db.store = db.store._replace(
            tab12=jax.vmap(tab12_of)(db.store),
            gmm_pack=jax.jit(jax.vmap(
                lambda d: gmm_pack_of(d, cfg.gmm)))(db.store))
        ts_full = np.concatenate([np.asarray(z["ts_store"]) for z in zs])
        db.ts_store = jnp.zeros((cap,), jnp.float32).at[:n].set(ts_full)
        db.state = jnp.asarray(zs[-1]["state"], jnp.int32)
        db.n = n
        db.seq_of_gidx = [int(x) for z in zs for x in z["seq_of_gidx"]]
        # host ts list: prefer the f64 'ts' entry (exact epoch-scale stamps)
        # over the f32 device ts_store
        ts64 = np.concatenate([np.asarray(z["ts"]) if "ts" in z.files
                               else np.asarray(z["ts_store"], np.float64)
                               for z in zs])
        db.ts = [float(t) for t in ts64]
        # counters map by name (counter_keys); legacy checkpoints predate the
        # key list and used the then-current 8 sorted names
        z_last = zs[-1]
        legacy = ["cand_aft_check1", "cand_aft_check2", "cand_aft_check3",
                  "n_hints", "overflow_cand", "overflow_hints",
                  "overflow_pass", "overflow_pot"]
        keys = ([str(k) for k in z_last["counter_keys"]]
                if "counter_keys" in z_last.files else legacy)
        for k, v in zip(keys, z_last["counters"]):
            if k in db.counters:
                db.counters[k] = int(v)
        return db

    @classmethod
    def merge(cls, dbs: List["ContourDB"],
              cfg: Optional[PipelineConfig] = None,
              capacity: Optional[int] = None) -> "ContourDB":
        """Compose multiple session maps into ONE frozen serving map.

        Multi-session composition has no reference analog (the C++ DB is
        rebuilt by replaying one sequence); it falls out of the dense-array
        design: the merged store is the row-wise concatenation of the
        sessions' archived prefixes. Every merged row is immediately
        searchable (state = all-popped) and timestamps are re-stamped to a
        monotone index, so the result is meant for map serving
        (localize_block_async / query_async) — continuing to STREAM into it
        would conflate the sessions' time axes; stream into a fresh DB and
        merge again instead. `session_of_gidx[g]` maps a result row back to
        (session index, original seq)."""
        dbs = [db for db in dbs if db.store is not None and db.n > 0]
        assert dbs, "nothing to merge"
        shapes = {jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)),
                               db.store) for db in dbs}
        assert len(shapes) == 1, (
            "sessions were built with different configs (store row layouts "
            "differ) — rebuild with one ContourManagerConfig before merging")
        n_total = sum(db.n for db in dbs)
        cap = capacity or n_total
        assert cap >= n_total, "capacity smaller than merged rows"
        out = cls(dbs[0].cfg if cfg is None else cfg, capacity=cap)
        out._init_store()
        parts = [jax.tree.map(lambda a, m=db.n: a[:m], db.store)
                 for db in dbs]
        out.store = jax.tree.map(
            lambda z, *xs: z.at[:n_total].set(jnp.concatenate(xs, axis=0)),
            out.store, *parts)
        out.keys_q = _keys_to_q_layout(out.store.keys,
                                       _kq_dtype(out.cfg))
        out.ts_store = out.ts_store.at[:n_total].set(
            jnp.arange(n_total, dtype=jnp.float32))
        out.state = jnp.asarray([n_total, n_total], jnp.int32)
        out.n = n_total
        out.seq_of_gidx = [s for db in dbs for s in db.seq_of_gidx[:db.n]]
        out.ts = list(range(n_total))
        out.session_of_gidx = [(i, s) for i, db in enumerate(dbs)
                               for s in db.seq_of_gidx[:db.n]]
        return out

    # -- batched throughput mode -------------------------------------------

    def process_block_async(self, descs: ScanDesc, seqs, ts_b) -> "BlockHandle":
        """Append + query a whole block of B scans in one dispatch.

        `descs` is a B-stacked ScanDesc (vmapped build_descriptor output),
        `ts_b` a (B,) device f32 of timestamps. Exact sequential parity with
        per-scan query/add/push ordering (see _process_block). The per-scan
        records come back through one BlockHandle."""
        B = int(ts_b.shape[0])
        assert B == len(seqs)
        if self.store is None:
            self._init_store(jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), descs))
        self._ensure_capacity(B)
        assert self.n + B <= self.capacity, "DB capacity exceeded"
        if self.recs_store is None:
            self.recs_store = jnp.zeros((self.capacity, RECORD_WIDTH),
                                        jnp.float32)
        row0 = self.n
        (self.store, self.keys_q, self.ts_store, self.state, self.recs_store,
         recs) = _process_block(self.store, self.keys_q, self.ts_store,
                                self.state, self.recs_store, descs,
                                jnp.asarray(ts_b, jnp.float32), self.cfg)
        self.seq_of_gidx.extend(int(s) for s in seqs)
        self.n += B
        return BlockHandle(recs, self, row0=row0)

    def step_chain_async(self, points_k, seqs, ts_k) -> "BlockHandle":
        """K sequential fused steps in ONE dispatch.

        `points_k` is (K, max_points, 4) (f32 or q16 wire format), `ts_k`
        a (K,) f32 of timestamps. Exact per-scan sequential semantics for
        ANY timestamp spacing (unlike process_block_async, which requires
        the >= min_elapse gap for its batched-query parity). One upload +
        one dispatch per K scans: the lowest-overhead sequential path.

        PRODUCTION LOWERING = the dynamic-trip-count chain (_step_chain_dyn)
        with k = K: the exact executable bench.py's headline times (a
        published number must be measured on the executable users call),
        and one compile serves every k <= buffer rows. The
        legacy lax.scan lowering stays available as step_chain_scan_async
        (record-parity pinned by test_step_chain_dyn_matches_step_chain)."""
        return self.step_chain_dyn_async(points_k, seqs, ts_k)

    def step_chain_scan_async(self, points_k, seqs, ts_k) -> "BlockHandle":
        """step_chain_async's LEGACY lax.scan lowering (see _step_chain):
        static chain length K (one compile per K), stacked records output.
        Kept for the loop-lowering A/B (bench.py scan cross-check phase) and
        as the lax.scan reference for the dyn-parity test."""
        K = int(ts_k.shape[0])
        assert K == len(seqs)
        if self.store is None:
            self._init_store()
        self._ensure_capacity(K)
        assert self.n + K <= self.capacity, "DB capacity exceeded"
        if self.recs_store is None:
            self.recs_store = jnp.zeros((self.capacity, RECORD_WIDTH),
                                        jnp.float32)
        row0 = self.n
        (self.store, self.keys_q, self.ts_store, self.state, self.recs_store,
         recs) = _step_chain(self.store, self.keys_q, self.ts_store,
                             self.state, self.recs_store, points_k,
                             jnp.asarray(ts_k, jnp.float32), self.cfg)
        self.seq_of_gidx.extend(int(s) for s in seqs)
        self.n += K
        return BlockHandle(recs, self, row0=row0)

    @staticmethod
    def stage_chain_k(k: int):
        """Pre-stage a chain length for `step_chain_dyn_async(k_dev=...)`:
        returns `(k, device_int32(k))`. Paying the upload here (instead of
        inside the call) keeps a timing loop free of a per-call
        host->device scalar upload."""
        return int(k), jax.device_put(jnp.int32(int(k)))

    def step_chain_dyn_async(self, points_buf, seqs, ts_k,
                             k_dev=None) -> "BlockHandle":
        """step_chain_async with a DYNAMIC chain length (see _step_chain_dyn):
        processes the first len(seqs) rows of `points_buf` (which may be
        longer). One executable per BUFFER shape — every chain length k
        reuses it, so repeated mixed-length chains (bench.py's differencing
        methodology) pay a single compile.

        `k_dev` optionally passes the chain length PRE-STAGED as a
        `(host_int, device_int32_scalar)` pair (see `stage_chain_k`): the
        default host-side jnp.int32(K) is a fresh host->device upload per
        call — timing loops should stage their k scalars up front. The host
        half lets this call validate the staged
        value against len(seqs) WITHOUT a device fetch (a mismatched device
        scalar would silently desync device row writes from host
        bookkeeping: self.n, seq_of_gidx, every later BlockHandle slice)."""
        K = int(len(seqs))
        if k_dev is not None:
            k_host, k_dev = k_dev
            assert int(k_host) == K, \
                f"staged k ({int(k_host)}) != len(seqs) ({K})"
        assert K <= int(points_buf.shape[0])
        ts_k = jnp.asarray(ts_k, jnp.float32)
        assert int(ts_k.shape[0]) == int(points_buf.shape[0]), \
            "ts_k must cover the full buffer (rows past k are ignored)"
        if self.store is None:
            self._init_store()
        self._ensure_capacity(K)
        assert self.n + K <= self.capacity, "DB capacity exceeded"
        if self.recs_store is None:
            self.recs_store = jnp.zeros((self.capacity, RECORD_WIDTH),
                                        jnp.float32)
        row0 = self.n
        (self.store, self.keys_q, self.ts_store, self.state,
         self.recs_store) = _step_chain_dyn(
            self.store, self.keys_q, self.ts_store, self.state,
            self.recs_store, points_buf, ts_k,
            jnp.int32(K) if k_dev is None else k_dev, self.cfg)
        self.seq_of_gidx.extend(int(s) for s in seqs)
        self.n += K
        return BlockHandle(self.recs_store[row0:row0 + K], self, row0=row0)

    def block_chain_async(self, descs_nb: ScanDesc, seqs, ts_nb
                          ) -> "BlockHandle":
        """NB sequential B-scan block steps in ONE dispatch (see
        _block_chain). `descs_nb` is (NB, B)-stacked, `ts_nb` (NB, B) f32;
        `seqs` lists all NB*B sequence ids in stream order."""
        nb, b = int(ts_nb.shape[0]), int(ts_nb.shape[1])
        assert nb * b == len(seqs)
        if self.store is None:
            self._init_store(jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape[2:], x.dtype),
                descs_nb))
        self._ensure_capacity(nb * b)
        assert self.n + nb * b <= self.capacity, "DB capacity exceeded"
        if self.recs_store is None:
            self.recs_store = jnp.zeros((self.capacity, RECORD_WIDTH),
                                        jnp.float32)
        row0 = self.n
        (self.store, self.keys_q, self.ts_store, self.state, self.recs_store,
         recs) = _block_chain(self.store, self.keys_q, self.ts_store,
                              self.state, self.recs_store, descs_nb,
                              jnp.asarray(ts_nb, jnp.float32), self.cfg)
        self.seq_of_gidx.extend(int(s) for s in seqs)
        self.n += nb * b
        return BlockHandle(recs.reshape(nb * b, recs.shape[-1]), self,
                           row0=row0)

    def block_chain_pts_async(self, points_nb, seqs, ts_nb) -> "BlockHandle":
        """NB sequential B-scan FULL block steps (descriptor build
        in-dispatch) in ONE dispatch (see _block_chain_pts). `points_nb` is
        (NB, B, max_points, 4) raw point clouds, `ts_nb` (NB, B) f32."""
        nb, b = int(ts_nb.shape[0]), int(ts_nb.shape[1])
        assert nb * b == len(seqs)
        assert points_nb.shape[:2] == (nb, b)
        if self.store is None:
            self._init_store()
        self._ensure_capacity(nb * b)
        assert self.n + nb * b <= self.capacity, "DB capacity exceeded"
        if self.recs_store is None:
            self.recs_store = jnp.zeros((self.capacity, RECORD_WIDTH),
                                        jnp.float32)
        row0 = self.n
        (self.store, self.keys_q, self.ts_store, self.state, self.recs_store,
         recs) = _block_chain_pts(self.store, self.keys_q, self.ts_store,
                                  self.state, self.recs_store, points_nb,
                                  jnp.asarray(ts_nb, jnp.float32), self.cfg)
        self.seq_of_gidx.extend(int(s) for s in seqs)
        self.n += nb * b
        return BlockHandle(recs.reshape(nb * b, recs.shape[-1]), self,
                           row0=row0)

    def localize_block_async(self, points_b,
                             chunk: Optional[int] = None
                             ) -> Optional["BlockHandle"]:
        """Batched localization against the FROZEN map: B point clouds in,
        B records out, nothing appended. `points_b` is (B, max_points, 4)
        f32 (or the int16 q16 wire format). Use after building/loading a map
        (e.g. ContourDB.load) to serve localization queries at block
        throughput.

        `chunk` bounds device memory for large B: the batched search holds a
        (chunk, Q, A, N*A) f32 distance tensor, so pick chunk ~= budget /
        (Q*A*N*A*4). Chunks dispatch independently (each is one fused
        dispatch); a non-divisible tail is PADDED to the chunk shape (zero
        point clouds query as found=False and are sliced off), so every
        chunk reuses the one compiled graph — no tail-shape recompile."""
        if self.store is None:
            return None
        B = int(points_b.shape[0])
        if chunk is None or B <= chunk:
            recs = _localize_block(self.store, self.state, points_b, self.cfg,
                                   self.keys_q)
        else:
            pad = (-B) % chunk
            if pad:
                points_b = jnp.concatenate([
                    jnp.asarray(points_b),
                    jnp.zeros((pad,) + tuple(points_b.shape[1:]),
                              points_b.dtype)])
            recs = jnp.concatenate([
                _localize_block(self.store, self.state, points_b[i:i + chunk],
                                self.cfg, self.keys_q)
                for i in range(0, B + pad, chunk)])[:B]
        return BlockHandle(recs, self, counters="serving_counters")

    # -- query ------------------------------------------------------------

    def query_async(self, query: ScanDesc) -> Optional[QueryHandle]:
        """Dispatch the fused query step; returns a QueryHandle (or None when
        the DB is empty). An empty search window yields found=False on device
        — no host sync needed to decide. Fetch results in blocks with
        drain_handles() to amortize link latency."""
        if self.store is None:
            return None
        rec = _query_step(self.store, query, self.state, self.cfg,
                          self.keys_q)
        return QueryHandle(rec, self)

    def query_ranged_knn(self, query: ScanDesc, profiler=None):
        """queryRangedKNN (contour_db.h:698-811): returns at most one
        (cand_gidx, correlation, T_delta(3,)) or None. Blocking wrapper of
        query_async."""
        h = self.query_async(query)
        if profiler:
            jax.block_until_ready(h.rec if h else None)
            profiler.record("query (fused)")
        return h.get() if h is not None else None

    def range_search(self, query: ScanDesc, max_dist_sq: float,
                     cap: int = 256):
        """layerRangeSearch analog (contour_db.h:204-216): all searchable
        keys within `max_dist_sq` of any of the query's (q_level, anchor)
        keys, sorted by ascending distance.

        Returns (hits, n_in_range): hits is a list of
        (gidx, level, seq_src, seq_tgt, dist_sq) tuples; n_in_range counts
        every in-range key and may exceed len(hits) when the fixed device cap
        truncates the result. Radii are capped at MAX_DIST_SQ (1e6,
        contour_db.h:30), the sentinel that marks invalid/unsearchable rows
        — true key distances beyond it are unreachable by design."""
        if self.store is None:
            return [], 0
        max_dist_sq = min(float(max_dist_sq), MAX_DIST_SQ)
        # state[1] is the device-resident searchable prefix: pass it directly
        # (one fetch total; an empty window just returns zero hits).
        # Radius membership is EXACT (reference layerRangeSearch semantics):
        # under keys_bf16 the maintained copy rounds boundary distances, so
        # this host-facing, once-in-a-while API derives the f32 layout
        # in-graph instead of reusing the bf16 streaming copy.
        kq = self.keys_q if self.keys_q.dtype == jnp.float32 else None
        packed = np.asarray(jax.device_get(_range_search(
            self.store.keys, query.keys, self.state[1],
            jnp.float32(max_dist_sq), tuple(self.cfg.db.q_levels), int(cap),
            self.cfg.db.topk_strategy, keys_q=kq)))
        n_total = (int(packed[0, 0]) << 20) + int(packed[0, 1])
        hits = [(int(r[0]), int(r[1]), int(r[2]), int(r[3]), float(r[4]))
                for r in packed[1:] if r[4] >= 0.0]
        return hits, n_total

    # -- host reference path (spec replica, used by parity tests) ----------

    def query_ranged_knn_host(self, query: ScanDesc, profiler=None):
        """Sequential host CandidateManager path — the readable spec.

        Identical semantics to query_ranged_knn but with the proposal merging
        on host and without hint compaction (all valid hits are processed)."""
        cfg = self.cfg
        if self.store is None or self.searchable_n == 0:
            return None

        q_levels = tuple(cfg.db.q_levels)
        nnk = cfg.db.nnk
        # search through the SAME maintained keys_q copy (incl. its bf16
        # dtype) as the fused device path, so host-vs-fused parity holds by
        # construction under keys_bf16
        gidx, seq_src, dist, valid = jax.jit(
            _search_impl, static_argnames=("q_levels", "nnk", "strategy"))(
            self.keys_q, query.keys, jnp.int32(self.searchable_n),
            q_levels, nnk, cfg.db.topk_strategy)
        if profiler:
            profiler.record("KNN search")

        Q, A, K = gidx.shape
        lv = np.array(q_levels, np.int32)
        level_h = np.broadcast_to(lv[:, None, None], (Q, A, K)).reshape(-1)
        seq_tgt_h = np.broadcast_to(np.arange(A, dtype=np.int32)[None, :, None],
                                    (Q, A, K)).reshape(-1)
        gidx_h = np.asarray(gidx).reshape(-1)
        seqs_h = np.asarray(seq_src).reshape(-1)
        valid_h = np.asarray(valid).reshape(-1)

        res = _gather_and_cascade(
            self.store, query,
            jnp.asarray(gidx_h), jnp.asarray(level_h), jnp.asarray(seqs_h),
            jnp.asarray(seq_tgt_h), jnp.asarray(valid_h),
            cfg.thres_lb, cfg.db.cont_sim, cfg.db.p_pot)
        if profiler:
            profiler.record("Constell")

        if cfg.db.dynamic_thres:
            # sequential re-gating with rising bars (contour_db.h:439-458)
            lbs = np.array([cfg.thres_lb.sim_constell.i_ovlp_sum,
                            cfg.thres_lb.sim_constell.i_ovlp_max_one,
                            cfg.thres_lb.sim_constell.i_in_ang_rng,
                            cfg.thres_lb.sim_pair.i_indiv_sim,
                            cfg.thres_lb.sim_pair.i_orie_sim])
            ubs = np.array([cfg.thres_ub.sim_constell.i_ovlp_sum,
                            cfg.thres_ub.sim_constell.i_ovlp_max_one,
                            cfg.thres_ub.sim_constell.i_in_ang_rng,
                            cfg.thres_ub.sim_pair.i_indiv_sim,
                            cfg.thres_ub.sim_pair.i_orie_sim])
            p1 = np.asarray(res.pass1)
            sc = np.stack([np.asarray(res.ovlp_sum), np.asarray(res.ovlp_max_one),
                           np.asarray(res.in_ang_rng), np.asarray(res.i_indiv_sim),
                           np.asarray(res.i_orie_sim)], axis=1)
            pass3 = np.zeros(len(p1), bool)
            for h in range(len(p1)):
                if p1[h] and (sc[h] >= lbs).all():
                    pass3[h] = True
                    lbs = np.minimum(np.maximum(lbs, sc[h, 4]), ubs)
        else:
            pass3 = np.asarray(res.pass3)
        mgr = HostCandidateManager(cfg)
        if pass3.any():
            pv = np.asarray(res.pair_valid)
            plev = np.asarray(res.pair_level)
            pss = np.asarray(res.pair_seq_src)
            pst = np.asarray(res.pair_seq_tgt)
            pperc = np.asarray(res.pair_area_perc)
            T_all = np.asarray(res.T_delta)
            for h in np.flatnonzero(pass3):
                sel = np.flatnonzero(pv[h])
                pairs = [(int(plev[h, i]), int(pss[h, i]), int(pst[h, i]))
                         for i in sel]
                percs = [float(pperc[h, i]) for i in sel]
                mgr.add_passing_hint(int(gidx_h[h]), T_all[h].astype(np.float64),
                                     pairs, percs)

        stats = mgr.tidy_stats()
        if not stats:
            if profiler:
                profiler.record("L2 opt")
            return None

        # batched GMM init correlation (screen 3/3 of tidyUpCandidates)
        C = len(stats)
        pad = max(self.gmm_pad, C)
        cg = np.zeros(pad, np.int32)
        Ti = np.zeros((pad, 3), np.float32)
        for i, (cand, _, _) in enumerate(stats):
            cg[i] = cand.gidx
            Ti[i] = cand.props[0].T
        src_gmm = _gather_gmm(self.store, jnp.asarray(cg),
                              tuple(cfg.gmm.levels), cfg.gmm.max_gmm_ellipses)
        tgt_gmm = gmm_from_desc(query, cfg.gmm)
        corr0, sel = init_correlation(src_gmm, tgt_gmm, jnp.asarray(Ti),
                                      scale=cfg.gmm.cov_dilate_scale)
        corr0 = np.asarray(corr0)

        post_lb = cfg.thres_lb.sim_post
        if cfg.db.dynamic_thres:
            post_ub = cfg.thres_ub.sim_post
            bars = np.array([post_lb.area_perc, post_lb.neg_est_dist,
                             post_lb.correlation])
            ubars = np.array([post_ub.area_perc, post_ub.neg_est_dist,
                              post_ub.correlation])
            keep = []
            for i, (cand, area, neg_d) in enumerate(stats):
                v = np.array([area, neg_d, corr0[i]])
                if (v >= bars).all():
                    keep.append(i)
                    bars = np.minimum(np.maximum(bars, v), ubars)
        else:
            keep = [i for i, (cand, area, neg_d) in enumerate(stats)
                    if area >= post_lb.area_perc
                    and neg_d >= post_lb.neg_est_dist
                    and corr0[i] >= post_lb.correlation]
        if not keep:
            if profiler:
                profiler.record("L2 opt")
            return None
        # fineOptimize (contour_db.h:604-648): refine up to max_fine_opt,
        # ranked by init correlation
        keep.sort(key=lambda i: -corr0[i])
        keep = keep[: self.max_fine]
        kidx = jnp.asarray(np.asarray(keep, np.int32))
        corr_f, T_f = optimize_correlation(
            jax.tree.map(lambda a: a[kidx], src_gmm), tgt_gmm,
            jnp.asarray(Ti)[kidx], sel[kidx],
            scale=cfg.gmm.cov_dilate_scale, iters=cfg.gmm.gn_iters)
        corr_f = np.asarray(corr_f)
        T_f = np.asarray(T_f)
        best = int(np.argmax(corr_f))
        if profiler:
            profiler.record("L2 opt")
        return (int(cg[keep[best]]), float(corr_f[best]), T_f[best].astype(np.float64))
