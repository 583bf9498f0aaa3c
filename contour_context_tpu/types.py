"""Fixed-shape per-scan descriptor pytree (the device replacement of ContourManager).

The reference keeps per-scan data in ragged std::vector structures
(contour_mng.h:426-436); here everything is a dense fixed-shape array with
validity masks so the whole descriptor + query path compiles once under jit.

Shapes (L = number of height levels, K = max contours/level, A = anchors/level,
M = max BCI neighbors):
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class ScanDesc(NamedTuple):
    """One scan's full descriptor: contour table + keys + BCIs + GMM summary."""
    # contour table, sorted per level by (cell count desc, min pixel asc)
    cnt: jnp.ndarray          # (L, K) int16   cell count (0 when slot invalid;
    #                           max 150*150 cells fits; consumers cast to f32)
    valid: jnp.ndarray        # (L, K) bool
    mean: jnp.ndarray         # (L, K, 2) f32  continuous (row, col)
    eig_vals: jnp.ndarray     # (L, K, 2) f32  ascending, clamped at point_sigma
    eig_vecs: jnp.ndarray     # (L, K, 2, 2) f32 columns = eigenvectors
    manual_cov: jnp.ndarray   # (L, K, 2, 2) f32 V diag(eig) V^T (contour.h:376-378)
    vol3_mean: jnp.ndarray    # (L, K) f32
    com_r: jnp.ndarray        # (L, K) f32     ||com - mean||
    ecc_feat: jnp.ndarray     # (L, K) bool
    cont_perc: jnp.ndarray    # (L, K) f32     cell_cnt / layer_cell_cnt
    layer_cell_cnt: jnp.ndarray  # (L,) int32
    n_cont: jnp.ndarray       # (L,) int32     number of valid contours
    # retrieval keys (contour_mng.h:689-895)
    keys: jnp.ndarray         # (L, A, 10) f32 zero when anchor invalid
    # BCI neighbor constellation, sorted by (bit, generation order).
    # HBM-compact dtypes (the store holds every scan ever added, so neighbor
    # tables dominate its footprint); run_cascade widens to int32 at entry.
    nei_valid: jnp.ndarray    # (L, A, M) bool
    nei_level: jnp.ndarray    # (L, A, M) int8
    nei_seq: jnp.ndarray      # (L, A, M) int8
    nei_bit: jnp.ndarray      # (L, A, M) int16 (0..255; 256 when invalid)
    nei_theta: jnp.ndarray    # (L, A, M) f32
    # GMM summary over the correlation levels (correlation.h:49-122)
    gmm_mask: jnp.ndarray     # (L, K) bool    95%-area prefix per level
    auto_corr: jnp.ndarray    # () f32         self L2 inner product
    # new fields go LAST for checkpoint compatibility (leaves save by
    # position; load_chain zero-fills missing trailing leaves)
    pix_overflow: jnp.ndarray  # () int32  ring-key pixels beyond cfg.pix_pool
    gmm_overflow: jnp.ndarray  # () int32  95%-area GMM ellipses beyond
    #                            max_gmm_ellipses (dropped from correlation)
    # pre-packed check-3 stats table over the DIST_BIN_LAYERS levels:
    # (4, J=10, 12) f32, channels [cnt, eig0, eig1, h, comr, mean0, mean1,
    # vec1x, vec1y, ecc, perc, ok] (ops/descriptor.pack_tab12). DERIVED from
    # the fields above and packed at build time so the cascade's per-pair
    # stats lookup is ONE row gather instead of nine. load_chain recomputes
    # it, so pre-r4 checkpoints stay loadable.
    tab12: jnp.ndarray        # (4, 10, 12) f32
    # pre-packed GMM source table over gmm_cfg.levels x max_gmm_ellipses:
    # flat (G*K*8,) f32, channels [mu0, mu1, cov00, cov01, cov10, cov11,
    # w(masked), majax] (ops/descriptor.pack_gmm). DERIVED; packed at build
    # time so the query's candidate-GMM gather is ONE flat row per candidate
    # instead of five gathers against multi-GB store leaves (mean /
    # manual_cov / eig_vals / cnt / gmm_mask), which made the "init"
    # stage's cost grow with the store capacity. load_chain recomputes it
    # (pre-r5 checkpoints stay loadable); save() skips it.
    gmm_pack: jnp.ndarray     # (G*K*8,) f32
