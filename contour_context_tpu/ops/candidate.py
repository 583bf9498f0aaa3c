"""On-device CandidateManager: proposal merging + tidy screens, zero host syncs.

Replaces the reference's sequential host-side CandidateManager
(contour_db.h:264-656) with a fixed-shape device replica so the whole query
step (search -> cascade -> merge -> GMM) is ONE XLA dispatch.  Semantics are an
exact replica of `addProposal` (contour_db.h:286-338) and the first two screens
of `tidyUpCandidates` (contour_db.h:494-545); parity is tested against the
host-side implementation in db.py (itself tested against a sequential oracle).

Layout: candidate poses are rows of fixed-size tables, keyed by the scan index
`gidx` in first-seen order (like the reference's `candidates_` vector); each
holds up to 4 proposals (the reference drops the 5th, contour_db.h:326).  The
constellation-pair union per proposal is a dense (NUM_SLOTS,) map indexed by
(level, seq_src, seq_tgt) with first-insert-wins percs (`setdefault`,
contour_db.h:305).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from contour_context_tpu.config import DIST_BIN_LAYERS, LAYER_AREA_WEIGHTS
from contour_context_tpu.ops.cascade import _clamp_ang

P_PROP = 4          # max proposals per candidate pose (contour_db.h:326)
N_LEV = 6           # level values 0..5 cover q_levels and DIST_BIN_LAYERS
N_SEQ = 10          # seq values 0..9 (dist_firsts)
NUM_SLOTS = N_LEV * N_SEQ * N_SEQ   # dense (level, seq_src, seq_tgt) key space
TF_TRANS_MERGE = 2.0    # proposal merge radius, m (contour_db.h:296)
TF_ANG_MERGE = 0.3      # proposal merge angle, rad (contour_db.h:296)


class CandidateState(NamedTuple):
    cand_gidx: jnp.ndarray    # (C,) int32, -1 when empty; first-seen order
    n_cand: jnp.ndarray       # () int32
    prop_n: jnp.ndarray       # (C,) int32 proposals in use
    prop_T: jnp.ndarray       # (C, 4, 3) f32 (x, y, theta) BEV delta
    prop_votes: jnp.ndarray   # (C, 4) int32 accumulated pair votes
    prop_taken: jnp.ndarray   # (C, 4, NUM_SLOTS) bool constellation union
    prop_perc: jnp.ndarray    # (C, 4, NUM_SLOTS) f32 first-insert percs
    overflow_cand: jnp.ndarray  # () int32 hints dropped: candidate table full
    overflow_pass: jnp.ndarray  # () int32 passing hints beyond the merge budget


def select_topk_stable(priority, mask, cap: int):
    """Budget-capped stable selection (shared by the hint cap and the merge
    budget). When the masked items fit `cap` this selects ALL of them in
    input order — the reference's sequential processing order, which the
    host-replica parity tests pin. When they overflow, it keeps the `cap`
    best by ascending `priority` (stable tie-break by position), still in
    input order among the kept. Returns (perm, sel_at_perm, n_masked,
    overflow): index `x[perm]` and mask with `sel_at_perm`."""
    n = mask.shape[0]
    order = jnp.argsort(jnp.where(mask, priority, jnp.inf), stable=True)
    rank = jnp.zeros(n, jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32))
    sel = mask & (rank < cap)
    perm = jnp.argsort(~sel, stable=True)[:cap]
    n_masked = jnp.sum(mask).astype(jnp.int32)
    overflow = jnp.maximum(0, n_masked - cap).astype(jnp.int32)
    return perm, sel[perm], n_masked, overflow


def _dense_pair_maps_rows(pair_valid, pair_level, pair_seq_src, pair_seq_tgt,
                          pair_perc):
    """(MP, P) ragged pair lists -> dense (MP, NUM_SLOTS) perc/taken maps.

    Duplicate ids within one hint's pair list (possible when a src neighbor
    is bit-adjacent to two tgt neighbors sharing a seq) keep the FIRST
    pair's perc — the reference's std::map setdefault semantics
    (contour_db.h:305), which the host replica in db.py also pins.
    Built as broadcast compares + reductions (no scatters: a (H, 601)
    scatter-add lowers to a serialized scatter)."""
    MP, P = pair_valid.shape
    ids = jnp.where(
        pair_valid,
        pair_level * (N_SEQ * N_SEQ) + pair_seq_src * N_SEQ + pair_seq_tgt,
        NUM_SLOTS)
    hit = ids[:, :, None] == jnp.arange(NUM_SLOTS,
                                        dtype=ids.dtype)[None, None, :]
    taken = jnp.any(hit, axis=1)                            # (MP, SLOTS)
    pos = jnp.arange(P, dtype=jnp.int32)[None, :, None]
    first_pos = jnp.min(jnp.where(hit, pos, P), axis=1)     # (MP, SLOTS)
    is_first = hit & (pos == first_pos[:, None, :])
    perc = jnp.sum(jnp.where(is_first, pair_perc[:, :, None], 0.0), axis=1)
    return perc, taken


@functools.partial(jax.jit, static_argnames=("n_cand_max", "n_pass_max"))
def merge_proposals(pass3, gidx, T_delta, pair_valid, pair_level,
                    pair_seq_src, pair_seq_tgt, pair_perc,
                    n_cand_max: int = 32, n_pass_max: int = 64
                    ) -> CandidateState:
    """Merge the passing hints' proposals (addProposal replica,
    contour_db.h:286-338), bit-identical to processing hints one by one in
    input order (the reference's (q_level, anchor, ranked-hit) order).

    Decomposition (an earlier form was ONE while_loop over all passing
    hints whose body carried the (C, 4, NUM_SLOTS) union maps — one
    serialized small-kernel iteration per hint):

    1. Hints touching DIFFERENT candidate poses never interact, so the
       sequential trip count drops from #passing hints to max hints per
       candidate row: a while_loop whose body advances EVERY candidate row
       by its j-th hint at once, touching only the small state (prop_T,
       votes, counts). Candidate rows are pre-assigned by first-seen order
       of gidx (exactly the sequential create order).
    2. The constellation-pair unions (the heavy (C, 4, NUM_SLOTS) maps) are
       order-insensitive given the loop's hint->(row, slot) assignment:
       taken = OR over assigned hints, perc = the FIRST assigned hint
       inserting each slot (setdefault). Computed afterwards as a segmented
       first-wins scan over the hints sorted by (row*4+slot, order) plus one
       exact one-hot matmul selecting each group's last row.
    """
    H = pass3.shape[0]
    C = n_cand_max
    MP = min(n_pass_max, H)

    votes_h = jnp.sum(pair_valid, axis=1).astype(jnp.int32)

    # Under merge-budget overflow (dense self-similar maps) keep the MP
    # strongest hints by constellation vote count — a hint's pair count is
    # the proposal weight, so dropping the weakest tail loses the least
    # evidence; see select_topk_stable for the under-cap parity guarantee.
    perm, _, n_pass, overflow_pass = select_topk_stable(
        -votes_h.astype(jnp.float32), pass3, MP)

    g = gidx[perm].astype(jnp.int32)
    T = T_delta[perm]
    votes = votes_h[perm]
    n_live = jnp.minimum(n_pass, MP)
    iota = jnp.arange(MP, dtype=jnp.int32)
    live = iota < n_live

    # --- candidate-row assignment: cidx = first-seen rank of gidx ---------
    BIGG = jnp.int32(0x7FFFFFFF)
    sg, sm = jax.lax.sort((jnp.where(live, g, BIGG), iota), num_keys=2)
    is_first_s = jnp.concatenate([jnp.ones((1,), bool), sg[1:] != sg[:-1]]) \
        & (sg != BIGG)
    # propagate each group's first member m along the group (groups ascend
    # in sorted order, so a packed running max carries (group ordinal, m))
    grp_ord = jnp.cumsum(is_first_s.astype(jnp.int32))
    packed = jnp.where(is_first_s, grp_ord * MP + sm, -1)
    fm_s = lax.associative_scan(jnp.maximum, packed) % MP   # first m, sorted
    # back to m order (MP-element scatter: trivial)
    first_m = jnp.zeros((MP,), jnp.int32).at[sm].set(fm_s)
    is_first_m = jnp.zeros((MP,), bool).at[
        jnp.where(is_first_s, sm, MP)].set(is_first_s, mode="drop")
    rank_at_m = jnp.cumsum(is_first_m.astype(jnp.int32)) - 1
    cidx_h = rank_at_m[first_m]                             # (MP,) row of hint
    drop_h = live & (cidx_h >= C)
    overflow_cand = jnp.sum(drop_h).astype(jnp.int32)
    keep_h = live & ~drop_h
    n_groups = jnp.sum(is_first_m).astype(jnp.int32)
    n_cand = jnp.minimum(n_groups, C)
    cand_gidx = jnp.full((C,), -1, jnp.int32).at[
        jnp.where(is_first_m & (rank_at_m < C), rank_at_m, C)].set(
        g, mode="drop")

    # within-row arrival order j (position within the (g, m) sorted group)
    pos_s = jnp.arange(MP, dtype=jnp.int32)
    gstart = lax.associative_scan(
        jnp.maximum, jnp.where(is_first_s, pos_s, -1))
    j_s = pos_s - gstart
    j_h = jnp.zeros((MP,), jnp.int32).at[sm].set(j_s)       # (MP,)
    hint_of = jnp.full((C, MP), -1, jnp.int32).at[
        jnp.where(keep_h, cidx_h, C), j_h].set(iota, mode="drop")
    nj = jnp.max(jnp.where(keep_h, j_h + 1, 0))

    # --- row-parallel sequential merge over the small state ---------------
    rows = jnp.arange(C, dtype=jnp.int32)
    slot_iota = jnp.arange(P_PROP, dtype=jnp.int32)[None, :]

    def wbody(carry):
        j, prop_T, prop_votes, prop_n, key_of_m = carry
        m_c = jax.lax.dynamic_slice(hint_of, (0, j), (C, 1))[:, 0]  # (C,)
        act = m_c >= 0
        mm = jnp.clip(m_c, 0, MP - 1)
        T_m = T[mm]                                         # (C, 3)
        w2 = votes[mm]                                      # (C,)

        c_m, s_m = jnp.cos(T_m[:, 2:3]), jnp.sin(T_m[:, 2:3])
        dx = prop_T[:, :, 0] - T_m[:, 0:1]
        dy = prop_T[:, :, 1] - T_m[:, 1:2]
        tx = c_m * dx + s_m * dy
        ty = -s_m * dx + c_m * dy
        dth = _clamp_ang(prop_T[:, :, 2] - T_m[:, 2:3])
        in_use = slot_iota < prop_n[:, None]
        match = in_use & (jnp.hypot(tx, ty) < TF_TRANS_MERGE) & \
            (jnp.abs(dth) < TF_ANG_MERGE)                   # (C, 4)
        has_match = jnp.any(match, axis=1)
        first = jnp.argmax(match, axis=1).astype(jnp.int32)
        can_append = prop_n < P_PROP    # ref: skip if len(props) > 3
        slot = jnp.where(has_match, first,
                         jnp.minimum(prop_n, P_PROP - 1))
        write = act & (has_match | can_append)
        oh = slot_iota == slot[:, None]                     # (C, 4)

        old_T = jnp.sum(jnp.where(oh[..., None], prop_T, 0.0), axis=1)
        old_votes = jnp.sum(jnp.where(oh, prop_votes, 0), axis=1)
        w1 = old_votes
        wsum = jnp.maximum(w1 + w2, 1).astype(jnp.float32)
        trans = (old_T[:, :2] * w1[:, None]
                 + T_m[:, :2] * w2[:, None]) / wsum[:, None]
        # angle blend replica (contour_db.h:313-319)
        diff = T_m[:, 2] - old_T[:, 2]
        diff = jnp.where(diff < 0, diff + 2 * math.pi, diff)
        diff = jnp.where(diff > math.pi, diff - 2 * math.pi, diff)
        ang = diff * w2.astype(jnp.float32) / wsum + old_T[:, 2]
        T_merged = jnp.concatenate([trans, ang[:, None]], axis=1)

        new_T = jnp.where(has_match[:, None], T_merged, T_m)
        new_votes = jnp.where(has_match, w1 + w2, w2)
        wsel = (write[:, None] & oh)
        prop_T = jnp.where(wsel[..., None], new_T[:, None, :], prop_T)
        prop_votes = jnp.where(wsel, new_votes[:, None], prop_votes)
        prop_n = prop_n + (write & ~has_match).astype(jnp.int32)
        key_c = rows * P_PROP + slot
        key_of_m = key_of_m.at[jnp.where(write, mm, MP)].set(
            key_c, mode="drop")
        return j + 1, prop_T, prop_votes, prop_n, key_of_m

    init = (jnp.int32(0),
            jnp.zeros((C, P_PROP, 3), jnp.float32),
            jnp.zeros((C, P_PROP), jnp.int32),
            jnp.zeros((C,), jnp.int32),
            jnp.full((MP,), -1, jnp.int32))
    _, prop_T, prop_votes, prop_n, key_of_m = lax.while_loop(
        lambda c: c[0] < nj, wbody, init)

    # --- constellation unions: segmented first-wins scan + one-hot matmul --
    # sort hints by (assigned key, arrival order m); build each hint's dense
    # pair map in THAT order, then an inclusive scan whose combine keeps the
    # earliest taken slot's perc within each key group. The group's last row
    # then holds the full union with setdefault percs — selected per key by
    # an exact one-hot f32 matmul (exactly one 1.0 per row: a pure copy).
    NK = C * P_PROP
    key_m = jnp.where(key_of_m >= 0, key_of_m, NK)
    sk, sm2 = jax.lax.sort((key_m, iota), num_keys=2)
    rows_src = perm[sm2]
    dperc_s, dtaken_s = _dense_pair_maps_rows(
        pair_valid[rows_src], pair_level[rows_src], pair_seq_src[rows_src],
        pair_seq_tgt[rows_src], pair_perc[rows_src])        # (MP, SLOTS)
    seg_start = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])

    def comb(a, b):
        fa, ta, pa = a
        fb, tb, pb = b
        f = fa | fb
        t = jnp.where(fb, tb, ta | tb)
        p = jnp.where(fb, pb, jnp.where(ta, pa, pb))
        return f, t, p

    _, t_scan, p_scan = lax.associative_scan(
        comb, (jnp.broadcast_to(seg_start[:, None], dtaken_s.shape),
               dtaken_s, dperc_s), axis=0)
    grp_end = jnp.concatenate([sk[1:] != sk[:-1], jnp.ones((1,), bool)])
    sel_end = ((sk[None, :] == jnp.arange(NK, dtype=sk.dtype)[:, None])
               & grp_end[None, :]).astype(jnp.float32)      # (NK, MP)
    # precision=HIGHEST: the one-hot matmul must be an exact copy of the
    # selected row. A backend's default f32 matmul may round operands to a
    # narrower format (bf16 or TF32), which would drift prop_perc off the
    # host CandidateManager the parity chain pins (taken_u alone would
    # survive via the 0.5 threshold).
    taken_u = jnp.matmul(sel_end, t_scan.astype(jnp.float32),
                         precision=jax.lax.Precision.HIGHEST) > 0.5
    perc_u = jnp.matmul(sel_end, p_scan,
                        precision=jax.lax.Precision.HIGHEST)
    prop_taken = taken_u.reshape(C, P_PROP, NUM_SLOTS)
    prop_perc = perc_u.reshape(C, P_PROP, NUM_SLOTS)

    return CandidateState(
        cand_gidx=cand_gidx,
        n_cand=n_cand,
        prop_n=prop_n,
        prop_T=prop_T,
        prop_votes=prop_votes,
        prop_taken=prop_taken,
        prop_perc=prop_perc,
        overflow_cand=overflow_cand,
        overflow_pass=overflow_pass,
    )


def dynamic_pass_scan(pass1, ovlp_sum, ovlp_max1, in_ang, indiv, orie,
                      lb, ub):
    """DYNAMIC_THRES re-gating of the check cascade (contour_db.h:439-458).

    Hints are re-gated sequentially: each full pass raises the working lower
    bounds (all five count thresholds) to that hint's final pair count,
    clamped by the upper-bound ensemble (alignLB/alignUB, algos.h:119-150).
    Scores are threshold-independent, so this replays the reference's
    sequential semantics on the batched cascade outputs.
    Returns (pass2, pass3) under the dynamic bars.
    """
    init = jnp.array([lb.sim_constell.i_ovlp_sum, lb.sim_constell.i_ovlp_max_one,
                      lb.sim_constell.i_in_ang_rng, lb.sim_pair.i_indiv_sim,
                      lb.sim_pair.i_orie_sim], jnp.int32)
    ubv = jnp.array([ub.sim_constell.i_ovlp_sum, ub.sim_constell.i_ovlp_max_one,
                     ub.sim_constell.i_in_ang_rng, ub.sim_pair.i_indiv_sim,
                     ub.sim_pair.i_orie_sim], jnp.int32)

    def step(carry, x):
        p1, ov, m1, ia, ind, oc = x
        pass2 = p1 & (ov >= carry[0]) & (m1 >= carry[1]) & (ia >= carry[2])
        pass3 = pass2 & (ind >= carry[3]) & (oc >= carry[4])
        new = jnp.minimum(jnp.maximum(carry, oc), ubv)
        return jnp.where(pass3, new, carry), (pass2, pass3)

    _, (pass2, pass3) = lax.scan(
        step, init, (pass1, ovlp_sum.astype(jnp.int32),
                     ovlp_max1.astype(jnp.int32), in_ang.astype(jnp.int32),
                     indiv.astype(jnp.int32), orie.astype(jnp.int32)))
    return pass2, pass3


def dynamic_post_scan(in_use, area, neg_d, corr0, lb_post, ub_post):
    """DYNAMIC_THRES post-processing screens (contour_db.h:532-574).

    Candidates are screened sequentially in first-seen order; each candidate
    passing all three screens (area %, distance censor, init correlation)
    raises the working lower bounds to its own scores, clamped by the upper
    bounds. Returns the keep mask.
    """
    init = jnp.array([lb_post.area_perc, lb_post.neg_est_dist,
                      lb_post.correlation], jnp.float32)
    ubv = jnp.array([ub_post.area_perc, ub_post.neg_est_dist,
                     ub_post.correlation], jnp.float32)

    def step(carry, x):
        use, a, d, c = x
        keep = use & (a >= carry[0]) & (d >= carry[1]) & (c >= carry[2])
        new = jnp.minimum(jnp.maximum(carry, jnp.stack([a, d, c])), ubv)
        return jnp.where(keep, new, carry), keep

    _, keep = lax.scan(step, init, (in_use, area.astype(jnp.float32),
                                    neg_d.astype(jnp.float32),
                                    corr0.astype(jnp.float32)))
    return keep


def _area_weights() -> jnp.ndarray:
    """(NUM_SLOTS,) weight of each dense slot = LAYER_AREA_WEIGHTS of its level."""
    w = [0.0] * N_LEV
    for j, lev in enumerate(DIST_BIN_LAYERS):
        w[lev] = LAYER_AREA_WEIGHTS[j]
    lev_of_slot = jnp.arange(NUM_SLOTS) // (N_SEQ * N_SEQ)
    return jnp.asarray(w, jnp.float32)[lev_of_slot]


class TidyResult(NamedTuple):
    alive: jnp.ndarray    # (C,) bool — static area + distance screens passed
    in_use: jnp.ndarray   # (C,) bool — candidate row populated
    T_sel: jnp.ndarray    # (C, 3) selected proposal transform
    area: jnp.ndarray     # (C,) weighted constellation area percentage
    neg_d: jnp.ndarray    # (C,) negated sensor-frame distance
    votes: jnp.ndarray    # (C,) selected proposal votes
    sel: jnp.ndarray      # (C,) selected proposal index


def tidy_candidates(st: CandidateState, area_perc_lb: float,
                    neg_est_dist_lb: float, n_row: int, n_col: int,
                    reso_row: float, reso_col: float) -> TidyResult:
    """Screens 1-2 of tidyUpCandidates (contour_db.h:494-545), vectorized.

    Per candidate: select the proposal with most votes (first wins ties, the
    reference's strictly-greater scan), screen by weighted constellation area
    percentage and by the negated estimated sensor-frame distance.
    """
    C = st.cand_gidx.shape[0]
    prop_use = jnp.arange(P_PROP)[None, :] < st.prop_n[:, None]  # (C, 4)
    votes_m = jnp.where(prop_use, st.prop_votes, -1)
    sel = jnp.argmax(votes_m, axis=1)                            # first max
    rows = jnp.arange(C)

    w = _area_weights()
    area_all = jnp.einsum("cps,s->cp",
                          jnp.where(st.prop_taken, st.prop_perc, 0.0), w,
                          precision=jax.lax.Precision.HIGHEST)
    area = area_all[rows, sel]
    T_sel = st.prop_T[rows, sel]
    votes = st.prop_votes[rows, sel]

    # distance censor in the sensor frame (getEstSensTF, correlation.h:287-296)
    ox = n_row / 2 - 0.5
    oy = n_col / 2 - 0.5
    c, s = jnp.cos(T_sel[:, 2]), jnp.sin(T_sel[:, 2])
    tx = c * ox - s * oy + T_sel[:, 0] - ox
    ty = s * ox + c * oy + T_sel[:, 1] - oy
    neg_d = -jnp.hypot(tx * reso_row, ty * reso_col)

    in_use = (rows < st.n_cand) & (st.prop_n > 0)
    alive = in_use & (area >= area_perc_lb) & (neg_d >= neg_est_dist_lb)
    return TidyResult(alive=alive, in_use=in_use, T_sel=T_sel, area=area,
                      neg_d=neg_d, votes=votes, sel=sel)
