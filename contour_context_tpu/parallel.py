"""Multi-chip scaling via jax.sharding: sharded key search + DP descriptor build.

The reference is single-process/single-thread (SURVEY.md §2.6) — there is no
distributed design to port. The scale-out story for this workload:

- **Database row sharding**: the retrieval-key matrix (N, L, A, 10) is sharded
  over the mesh's "data" axis on N (scans). Each device computes its local
  masked top-k; a shard_map all_gather over the interconnect merges per-shard
  candidates and
  a replicated global top-k picks the winners. Communication is O(devices * k)
  floats per query — negligible vs HBM scan of the shard.
- **Data-parallel descriptor build**: independent scans batch-vmapped over the
  same axis (descriptor extraction is embarrassingly parallel; insertion is
  delayed >=15 s anyway, contour_db.h:54-57, so building ahead is legal).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from contour_context_tpu.config import ContourManagerConfig, GMMOptConfig, PipelineConfig
from contour_context_tpu.db import MAX_DIST_SQ, _topk_min


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


@functools.partial(jax.jit,
                   static_argnames=("q_levels", "nnk", "mesh",
                                    "topk_strategy"))
def sharded_search(db_keys, q_keys, searchable_n,
                   q_levels: Tuple[int, ...], nnk: int, mesh: Mesh,
                   topk_strategy: str = "cover"):
    """Row-sharded brute-force top-k key search.

    db_keys  (N, L, A, 10) sharded on N over mesh axis "data";
    q_keys   (L, A, 10) replicated; searchable_n scalar (global scan count).
    Returns (gidx, seq_src, dist, valid) each (Q, A, nnk) — identical to the
    single-chip ContourDB._search result (db.py), devices permitting.

    N need NOT divide the mesh size: shard_map requires even shards, so a
    non-divisible N is zero-padded in-graph to the next multiple (zero key
    rows are already the invalid sentinel — row_valid masks them, and any
    padded row that sneaks into a shard's top-k carries MAX_DIST_SQ and
    fails the validity bound). NOTE: this in-graph pad serves inputs that
    arrive replicated/uncommitted; an input ALREADY device_put with a
    P("data") sharding must be pre-padded at placement time
    (pad_rows_to_mesh) — jax rejects uneven row-sharded device_puts.
    Exercised by dryrun_multichip's uneven case (N = 2*mesh+2).
    """
    lv = jnp.array(q_levels, jnp.int32)
    A = db_keys.shape[2]
    n_dev = mesh.devices.size
    pad = (-db_keys.shape[0]) % n_dev
    if pad:
        db_keys = jnp.concatenate(
            [db_keys, jnp.zeros((pad,) + db_keys.shape[1:], db_keys.dtype)])
    # small shards can hold fewer rows than the k bound (single-chip twin
    # clamps identically in db._search_impl)
    nnk = min(nnk, (db_keys.shape[0] // n_dev) * A)

    def local(db_rows, q, n_searchable):
        # db_rows: (N_loc, L, A, D) local shard
        ax = jax.lax.axis_index("data")
        N_loc = db_rows.shape[0]
        base = ax.astype(jnp.int32) * N_loc
        lo, nq = q_levels[0], len(q_levels)
        if q_levels == tuple(range(lo, lo + nq)):
            sel = jax.lax.slice_in_dim(db_rows, lo, lo + nq, axis=1)
        else:
            sel = db_rows[:, lv]
        D = db_rows.shape[3]
        kt = sel.transpose(1, 3, 0, 2).reshape(nq, D, N_loc * A)
        qk = q[lv]
        row_valid = jnp.abs(kt.astype(jnp.float32)).sum(1) > 0
        scan_of_row = base + jnp.repeat(jnp.arange(N_loc, dtype=jnp.int32), A)[None]
        ok = row_valid & (scan_of_row < n_searchable)
        # BITWISE-same distance as db._key_distances (row-minor direct
        # squared difference — see its docstring for why not a matmul), so
        # sharded-vs-single hit sets agree even on near-ties; bf16 keys
        # upcast in-register inside the fused accumulation
        f32 = jnp.float32
        qk_f = qk.astype(f32)
        d2 = jnp.zeros((nq, A, N_loc * A), f32)
        for d in range(D):
            diff = (kt[:, d, :][:, None, :].astype(f32)
                    - qk_f[:, :, d][:, :, None])
            d2 = d2 + diff * diff
        d2 = jnp.where(ok[:, None, :], d2, MAX_DIST_SQ)
        # two-stage exact min-k (db._topk_min) for big shards: avoids the
        # sort-based full-width TopK that dominates at city scale
        dist_loc, idx = _topk_min(d2, nnk, topk_strategy)
        gscan = base + idx // A
        seq = idx % A
        # gather per-device candidates: (Q, A, k) -> all_gather over devices
        cat = lambda x: jax.lax.all_gather(x, "data", axis=2, tiled=True)
        return cat(dist_loc), cat(gscan), cat(seq)

    dist_all, gidx_all, seq_all = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(db_keys, q_keys, searchable_n)

    # global top-k over the device-merged candidate pool (replicated, tiny)
    neg, pick = jax.lax.top_k(-dist_all, nnk)
    dist = -neg
    gidx = jnp.take_along_axis(gidx_all, pick, axis=2)
    seq_src = jnp.take_along_axis(seq_all, pick, axis=2)

    k0, k1, k2 = (q_keys[lv][..., i].astype(jnp.float32) for i in range(3))
    ub = (jnp.maximum((k0 - k0 * 0.8) ** 2, (k0 - k0 / 0.8) ** 2)
          + jnp.maximum((k1 - k1 * 0.8) ** 2, (k1 - k1 / 0.8) ** 2)
          + jnp.maximum((k2 - k2 * 0.8 * 0.75) ** 2, (k2 - k2 / (0.8 * 0.75)) ** 2))
    q_valid = jnp.abs(q_keys[lv]).sum(-1) > 0
    valid = (dist < jnp.minimum(ub[..., None], MAX_DIST_SQ)) & q_valid[..., None]
    return gidx, seq_src, dist, valid


def dp_build_descriptors(points_batch, cfg: ContourManagerConfig,
                         gmm_cfg: GMMOptConfig, mesh: Mesh):
    """Data-parallel descriptor build: (B, P, 4) sharded on B over "data"."""
    from contour_context_tpu.ops.descriptor import build_descriptor

    sharding = NamedSharding(mesh, P("data"))
    points_batch = jax.device_put(points_batch, sharding)

    @functools.partial(jax.jit, static_argnames=("cfg", "gmm_cfg"))
    def batch_build(pb, cfg, gmm_cfg):
        return jax.vmap(lambda p: build_descriptor(p, cfg, gmm_cfg))(pb)

    return batch_build(points_batch, cfg, gmm_cfg)


def pad_rows_to_mesh(x, mesh: Mesh):
    """Zero-pad dim 0 to a multiple of the mesh size.

    jax.device_put with a row-sharded NamedSharding REQUIRES divisibility
    (verified on jaxlib 0.9.0: uneven global dim 0 is a ValueError), so
    uneven capacities are padded at the sharding boundary. Zero rows are
    the store's invalid sentinel everywhere (zero keys fail row_valid; rows
    >= searchable_n are never searched), so results are unchanged."""
    n_dev = mesh.devices.size
    pad = (-x.shape[0]) % n_dev
    if pad:
        x = jnp.concatenate(
            [jnp.asarray(x),
             jnp.zeros((pad,) + tuple(x.shape[1:]), x.dtype)])
    return x


def shard_store(store, mesh: Mesh):
    """Lay the DB store's scan axis out over the mesh's "data" axis.

    The capacity axis (leading) of every ScanDesc buffer is row-sharded; the
    brute-force key search then scans only local rows per device and GSPMD
    inserts the top-k combine over the interconnect. Capacities not divisible by the
    mesh are zero-padded (pad_rows_to_mesh) — padded rows are invalid
    sentinels and never searchable."""
    sh = NamedSharding(mesh, P("data"))
    return jax.tree.map(
        lambda a: jax.device_put(pad_rows_to_mesh(a, mesh), sh), store)


def sharded_query_step(store, query, state, pcfg: PipelineConfig, mesh: Mesh):
    """The fused query step over a row-sharded store.

    store: ScanDesc with leading (capacity) axis sharded over "data";
    query/state replicated. GSPMD partitions the search (each device scans its
    rows) and gathers the <=max_check_cands candidate rows for the cascade;
    the result record is replicated. Semantically identical to the single-chip
    db._query_step."""
    from contour_context_tpu.db import _query_step_impl

    rep = NamedSharding(mesh, P())

    @functools.partial(jax.jit, static_argnames=("pcfg",),
                       out_shardings=rep)
    def step(store, query, state, pcfg):
        return _query_step_impl(store, query, state[1], pcfg)

    return step(store, query, state, pcfg)
