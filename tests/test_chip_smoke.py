"""CPU checks of what chip_smoke.py and the GPU path rely on: the device
gate, the compile-cache rule, float32 matmul precision on the query path,
the numpy references the smoke test compares the device against, and the
decoy-tiled map it serves."""

import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_device_gate_refuses_cpu():
    import jax

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


def test_compile_cache_dir(monkeypatch, tmp_path):
    import jax

    from contour_context_tpu.utils import compile_cache as cc

    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    assert cc.cache_dir() == os.path.join(checkout, ".jax_cache")
    assert cc.cache_dir("cpu") == os.path.join(checkout, ".jax_cache", "cpu")

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    assert cc.cache_dir() == str(tmp_path)
    assert cc.cache_dir("cpu") == str(tmp_path)
    # with the variable set, JAX reads it itself: nothing is overridden
    assert cc.enable_compile_cache("cpu") == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def _dot_generals(jaxpr):
    """Every dot_general equation of a jaxpr, nested jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                if hasattr(sub, "eqns"):
                    yield from _dot_generals(sub)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    yield from _dot_generals(sub.jaxpr)


def _assert_highest(closed):
    import jax

    hi = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    dots = [e for e in _dot_generals(closed.jaxpr)
            if any(v.aval.dtype == np.float32 for v in e.invars)]
    assert dots, "no float32 dot_general traced"
    for e in dots:
        assert e.params["precision"] == hi, (e, e.params["precision"])
    return len(dots)


def test_lm_solve_runs_at_highest_precision():
    import jax
    import jax.numpy as jnp

    from contour_context_tpu.ops.gmm import GmmScan, optimize_correlation

    C, G, K = 2, 4, 8
    src = GmmScan(mus=jnp.zeros((C, G, K, 2)), covs=jnp.ones((C, G, K, 2, 2)),
                  ws=jnp.ones((C, G, K)), majax=jnp.ones((C, G, K)),
                  auto_corr=jnp.ones((C,)))
    tgt = jax.tree.map(lambda a: a[0], src)
    fn = functools.partial(optimize_correlation, scale=2.0, iters=2)
    closed = jax.make_jaxpr(fn)(src, tgt, jnp.zeros((C, 3)),
                                jnp.ones((C, G, K, K), bool))
    assert _assert_highest(closed) >= 1


def test_proposal_area_einsum_runs_at_highest_precision():
    import jax
    import jax.numpy as jnp

    from contour_context_tpu.ops.candidate import (merge_proposals,
                                                   tidy_candidates)

    H, P = 8, 4

    def merge_and_tidy(pass3, gidx, T, pv, plev, pss, pst, perc):
        st = merge_proposals(pass3, gidx, T, pv, plev, pss, pst, perc,
                             n_cand_max=4, n_pass_max=8)
        return tidy_candidates(st, 0.03, -5.01, 150, 150, 1.0, 1.0)

    i32 = functools.partial(jnp.zeros, dtype=jnp.int32)
    closed = jax.make_jaxpr(merge_and_tidy)(
        jnp.ones(H, bool), i32(H), jnp.zeros((H, 3)), jnp.ones((H, P), bool),
        i32((H, P)), i32((H, P)), i32((H, P)), jnp.zeros((H, P)))
    # the one-hot union matmuls (x2) and the area einsum
    assert _assert_highest(closed) >= 3


def _planted_store(n, seed=0):
    """(n, L=6, A=6, D=10) f32 keys with zeros for invalid anchors and
    planted exact duplicates, plus a query that also appears in the store."""
    rng = np.random.default_rng(seed)
    keys = rng.uniform(1.0, 20.0, (n, 6, 6, 10)).astype(np.float32)
    keys[rng.random((n, 6, 6)) < 0.2] = 0.0
    q = keys[3].copy()
    keys[40:60] = keys[11]
    keys[200:210] = q
    keys[n - 30:n - 10] = keys[200]
    return keys, q


@pytest.mark.parametrize("strategy", ["block", "cover"])
def test_topk_reference_matches_topk_min_with_ties(strategy):
    import jax.numpy as jnp

    from contour_context_tpu.db import TOPK_BLOCK, _topk_min

    rng = np.random.default_rng(1)
    M = 4 * TOPK_BLOCK + 100                 # the two-stage paths
    d2m = (rng.integers(0, 300, (3, 6, M)) / 7.0).astype(np.float32)
    d2m[..., 17:40] = d2m[..., :1]           # long runs of equal values
    want_v, want_i = chip_smoke.topk_min_reference(d2m, 50)
    v, i = _topk_min(jnp.asarray(d2m), 50, strategy)
    np.testing.assert_array_equal(np.asarray(i), want_i)
    np.testing.assert_array_equal(np.asarray(v), want_v)


@pytest.mark.parametrize("strategy", ["block", "cover2"])
def test_search_reference_matches_search_with_ties(strategy):
    import jax.numpy as jnp

    from contour_context_tpu.db import _keys_to_q_layout, _search

    keys, q = _planted_store(2800)           # N*A >= 4*TOPK_BLOCK for cover2
    searchable = 2790
    dev = _search(jnp.asarray(keys), jnp.asarray(q), jnp.int32(searchable),
                  (1, 2, 3), 50, strategy)
    out = chip_smoke.match_search(dev, np.asarray(_keys_to_q_layout(keys)), q,
                                  searchable, (1, 2, 3), 50)
    assert out["hits"] > 0


def test_decoy_tiled_store_answers_like_the_untiled_rows():
    import jax.numpy as jnp

    from __graft_entry__ import tiled_store
    from contour_context_tpu.db import _keys_to_q_layout, _search
    from contour_context_tpu.types import ScanDesc

    n, n_map = 300, 1000
    keys, q = _planted_store(n)
    store = ScanDesc(*[jnp.zeros((n, 1))] * len(ScanDesc._fields))._replace(
        keys=jnp.asarray(keys))
    plain = tiled_store(store, n, n_map, decoys=False)
    decoy = tiled_store(store, n, n_map, decoys=True)
    np.testing.assert_array_equal(np.asarray(plain.keys)[n:2 * n], keys)
    dk = np.asarray(decoy.keys)
    np.testing.assert_array_equal(dk[:n], keys)
    np.testing.assert_array_equal(dk[n:] == 0, np.asarray(plain.keys)[n:] == 0)
    assert (dk[n:][dk[n:] != 0] >= 1e3).all()

    ref = _search(jnp.asarray(keys), jnp.asarray(q), jnp.int32(n), (1, 2, 3),
                  50)
    got = _search(decoy.keys, jnp.asarray(q), jnp.int32(n_map), (1, 2, 3), 50)
    assert (chip_smoke.hits_of(got[0], got[1], got[3])
            == chip_smoke.hits_of(ref[0], ref[1], ref[3]))
    # plain tiles fill the nnk slots with copies of the nearest keys
    tiled = _search(plain.keys, jnp.asarray(q), jnp.int32(n_map), (1, 2, 3),
                    50)
    assert (np.asarray(tiled[0]) >= n).any()
    kq = np.asarray(_keys_to_q_layout(np.asarray(plain.keys)))
    chip_smoke.match_search(tiled, kq, q, n_map, (1, 2, 3), 50)


@pytest.mark.parametrize("p", [0.2, 0.25, 0.95])
def test_count_ratio_gates_are_exact(p):
    """scaled_ratio decides num/den vs p for cell counts exactly as the
    reference's double arithmetic, ties included (a float division that is
    not correctly rounded flips those ties)."""
    import jax.numpy as jnp

    from contour_context_tpu.ops.cascade import scaled_ratio

    num, den = np.meshgrid(np.arange(0, 400), np.arange(1, 401))
    lhs, rhs = scaled_ratio(jnp.asarray(num, jnp.float32),
                            jnp.asarray(den, jnp.float32), p)
    lhs, rhs = np.asarray(lhs), np.asarray(rhs)
    ratio = num / den.astype(np.float64)
    np.testing.assert_array_equal(lhs > rhs, ratio > p)
    np.testing.assert_array_equal(lhs < rhs, ratio < p)
    assert (ratio == p).any()        # exact ties are in the grid
    with pytest.raises(ValueError, match="short decimal"):
        scaled_ratio(jnp.ones(2), jnp.ones(2), 0.123456789)


def test_gmm_area_prefix_tie_excludes_the_ellipse():
    """An ellipse whose preceding area is exactly min_area_perc of the level
    is outside the 95%-area prefix (oracle.build_gmm stops at >=)."""
    import jax.numpy as jnp

    from contour_context_tpu.config import GMMOptConfig
    from contour_context_tpu.ops.descriptor import gmm_summary

    L, K = 6, 8
    cnt = np.zeros((L, K), np.int32)
    cnt[2, :3] = [500, 374, 46]          # 874 / 920 = 0.95 before slot 2
    tab = dict(cnt=jnp.asarray(cnt), valid=jnp.asarray(cnt > 0),
               layer_cell_cnt=jnp.asarray(cnt.sum(1)),
               mean=jnp.zeros((L, K, 2)),
               manual_cov=jnp.broadcast_to(jnp.eye(2), (L, K, 2, 2)))
    mask, _, _ = gmm_summary(tab, GMMOptConfig())
    np.testing.assert_array_equal(np.asarray(mask)[2, :3], [True, True,
                                                            False])
