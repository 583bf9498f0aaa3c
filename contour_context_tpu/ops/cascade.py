"""Batched candidate check cascade on device.

The reference runs checkCandWithHint sequentially per retrieved key hit
(~18 hits/key avg, contour_db.h:374-488). Here ALL hints of a query are
verified in one XLA dispatch over a padded hint axis H:

  check 1  anchor ellipse similarity      (contour.h:278-329)
  check 2  BCI constellation consensus    (contour_mng.h:288-388)
  check 3  pairwise sim + orientation     (contour_mng.h:1124-1242)
  TF       closed-form 2-D umeyama        (contour_mng.h:1251-1277)

Inputs are per-hint gathered candidate tables (src_*) and the query ScanDesc.
Early exits become masks; every hint computes everything (batched,
branch-free).
"""

from __future__ import annotations

import fractions
import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from contour_context_tpu.config import (
    CandidateScoreEnsemble,
    ContourSimThresConfig,
)

P_MAX = 64      # constellation pairs kept per hint (window + anchor)
P_POT = 512     # potential (bit-adjacent) pairs kept for the angular window
                # (the reference iterates all; dense self-similar scenes can
                # exceed 256 — the 512 slice of the ascending-angle sort keeps
                # the window search exact unless truncation actually occurs)
ANG_RANGE = math.pi / 16
SHAFT_TOP = 10  # pairs considered for the shaft (contour_mng.h:1174)


class CascadeResult(NamedTuple):
    pass1: jnp.ndarray        # (H,) bool — anchor checkSim
    pass2: jnp.ndarray        # (H,) bool — constellation consensus
    pass3: jnp.ndarray        # (H,) bool — pairwise + orientation
    ovlp_sum: jnp.ndarray     # (H,) int32
    ovlp_max_one: jnp.ndarray  # (H,) int32
    in_ang_rng: jnp.ndarray   # (H,) int32
    i_indiv_sim: jnp.ndarray  # (H,) int32
    i_orie_sim: jnp.ndarray   # (H,) int32
    pair_valid: jnp.ndarray   # (H, P) bool  — final filtered constellation
    pair_level: jnp.ndarray   # (H, P) int32
    pair_seq_src: jnp.ndarray  # (H, P) int32
    pair_seq_tgt: jnp.ndarray  # (H, P) int32
    pair_area_perc: jnp.ndarray  # (H, P) f32
    T_delta: jnp.ndarray      # (H, 3) f32 (x, y, theta): T_tgt = T_delta * T_src
    pot_overflow: jnp.ndarray  # (H,) bool — bit-adjacent pairs exceeded P_POT
    win_overflow: jnp.ndarray  # (H,) bool — consensus window exceeded P_MAX-1
    #                             members (pairs dropped from check 3 / TF)


# ---------------------------------------------------------------------------

def scaled_ratio(num, den, p: float):
    """(num * D, den * N) as int32, with p = N / D read from p's shortest
    decimal form (0.2 -> 1/5, 0.95 -> 19/20): comparing the two compares
    num / den with p EXACTLY, for integer-valued num and den.

    Cell-count ratios land exactly on such thresholds often (7/35 vs 0.2,
    874/920 vs 0.95). A float division decides those ties only if it is
    correctly rounded, and GPU backends may divide to within an ulp instead,
    which flips the gate (an ellipse joins the GMM, a hint fails check 1).
    The integer form decides every case as the reference's double
    arithmetic does: two ratios with denominators <= 22500 that differ at
    all differ by far more than a double's rounding."""
    frac = fractions.Fraction(repr(float(p)))
    if frac.denominator > 4096:
        raise ValueError(f"threshold {p} needs a short decimal form (at "
                         "most 4096 as the denominator) to be compared "
                         "exactly against cell-count ratios")
    to_int = lambda x: jnp.round(jnp.asarray(x)).astype(jnp.int32)
    return (to_int(num) * frac.denominator, to_int(den) * frac.numerator)


def check_sim_batched(cnt_s, eig_s, h_s, comr_s, cnt_t, eig_t, h_t, comr_t,
                      th: ContourSimThresConfig):
    """Vectorized ContourView::checkSim (contour.h:278-329). All args broadcast."""
    cnt_s = cnt_s.astype(jnp.float32)
    cnt_t = cnt_t.astype(jnp.float32)

    def diff_perc(a, b, p):
        return jnp.abs((a - b) / jnp.maximum(a, b)) > p

    def diff_delt(a, b, d):
        return jnp.abs(a - b) > d

    # cell counts are integers: their relative difference is compared
    # exactly (scaled_ratio), the float quantities below by division
    lhs, rhs = scaled_ratio(jnp.abs(cnt_s - cnt_t), jnp.maximum(cnt_s, cnt_t),
                            th.tp_cell_cnt)
    fail = (lhs > rhs) & diff_delt(cnt_s, cnt_t, th.ta_cell_cnt)
    fail |= (jnp.maximum(eig_s[..., 1], eig_t[..., 1]) > 2.0) & \
        diff_perc(jnp.sqrt(eig_s[..., 1]), jnp.sqrt(eig_t[..., 1]), th.tp_eigval)
    fail |= (jnp.maximum(eig_s[..., 0], eig_t[..., 0]) > 2.0) & \
        diff_perc(jnp.sqrt(eig_s[..., 0]), jnp.sqrt(eig_t[..., 0]), th.tp_eigval)
    fail |= (jnp.maximum(cnt_s, cnt_t) > 15) & \
        diff_delt(h_s, h_t, th.ta_h_bar)
    fail |= diff_delt(comr_s, comr_t, th.ta_rcom) & \
        diff_perc(comr_s, comr_t, th.tp_rcom)
    return ~fail


def _clamp_ang(a):
    return a - jnp.floor((a + math.pi) / (2 * math.pi)) * (2 * math.pi)


def _bits_from_nei(bit, valid):
    """(H, M) neighbor bit table -> (H, 256) bool mask."""
    onehot = (bit[..., None] == jnp.arange(256)[None, None]) & valid[..., None]
    return jnp.any(onehot, axis=-2)


# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("thres_lb", "cont_sim", "p_pot"))
def run_cascade(
    # per-hint candidate-side gathers
    src_anchor,        # dict: cnt, eig, h, comr           — (H,) / (H,2)
    src_nei,           # dict: valid, level, seq, bit, theta — (H, M)
    src_tab12,         # (H, 4, J, 12) f32 packed check-3 stats table
                       #   (ops/descriptor.pack_tab12 channel order), gathered
                       #   per hint from the archived store's tab12 rows
    # query-side per-hint gathers
    tgt_anchor, tgt_nei,
    tgt_tab12,         # (4, J, 12) f32 — the query scan's own packed table
                       #   (identical for every hint; gathered per pair below)
    hint_valid,        # (H,) bool
    anchor_level,      # (H,) int32 — q_level of the hint
    anchor_seq_src, anchor_seq_tgt,   # (H,) int32
    thres_lb: CandidateScoreEnsemble,
    cont_sim: ContourSimThresConfig,
    p_pot: int | None = None,   # angular-window pair capacity; None = module
                                #   P_POT (config.ContourDBConfig.p_pot feeds
                                #   this from the db paths)
) -> CascadeResult:
    H, M = src_nei["bit"].shape
    pot = P_POT if p_pot is None else p_pot

    # neighbor tables arrive in HBM-compact dtypes (int8 level/seq, int16
    # bit); widen before any arithmetic (level*100+seq*10 overflows int8)
    def _widen(nei):
        return dict(nei, level=jnp.asarray(nei["level"], jnp.int32),
                    seq=jnp.asarray(nei["seq"], jnp.int32),
                    bit=jnp.asarray(nei["bit"], jnp.int32))

    src_nei = _widen(src_nei)
    tgt_nei = _widen(tgt_nei)

    # ---- check 1: anchor similarity -------------------------------------
    pass1 = hint_valid & check_sim_batched(
        src_anchor["cnt"], src_anchor["eig"], src_anchor["h"], src_anchor["comr"],
        tgt_anchor["cnt"], tgt_anchor["eig"], tgt_anchor["h"], tgt_anchor["comr"],
        cont_sim)

    # ---- check 2: BCI constellation consensus ---------------------------
    bits_s = _bits_from_nei(src_nei["bit"], src_nei["valid"])
    bits_t = _bits_from_nei(tgt_nei["bit"], tgt_nei["valid"])
    shl = jnp.concatenate([jnp.zeros((H, 1), bool), bits_s[:, :-1]], axis=1)
    shr = jnp.concatenate([bits_s[:, 1:], jnp.zeros((H, 1), bool)], axis=1)
    and1 = jnp.sum(bits_s & bits_t, axis=1)
    and2 = jnp.sum(shl & bits_t, axis=1)
    and3 = jnp.sum(shr & bits_t, axis=1)
    ovlp_sum = (and1 + and2 + and3).astype(jnp.int32)
    max_one = jnp.maximum(and1, jnp.maximum(and2, and3)).astype(jnp.int32)
    gate2 = (ovlp_sum >= thres_lb.sim_constell.i_ovlp_sum) & \
        (max_one >= thres_lb.sim_constell.i_ovlp_max_one)

    # potential pairs: bit distance <= 1 (contour_mng.h:311-334)
    close = (jnp.abs(src_nei["bit"][:, :, None] - tgt_nei["bit"][:, None, :]) <= 1) \
        & src_nei["valid"][:, :, None] & tgt_nei["valid"][:, None, :]
    orie = _clamp_ang(tgt_nei["theta"][:, None, :] - src_nei["theta"][:, :, None])
    # flatten in the reference's insertion order — tgt-outer, src-inner
    # (contour_mng.h:311-334 iterates tgt neighbors then bit-adjacent src) —
    # so stable sort ties resolve exactly like the sequential list sort
    orie = jnp.where(close, orie, jnp.inf).transpose(0, 2, 1).reshape(H, M * M)
    # flat index f = tgt*M + src encodes BOTH slot ids — co-sort the one
    # packed iota instead of two separate slot operands (sort traffic is
    # per-operand; the unpack is free elementwise math)
    p_flat = jnp.broadcast_to(jnp.arange(M * M, dtype=jnp.int32)[None],
                              (H, M * M))

    pot_overflow = jnp.sum(close.reshape(H, -1), axis=1) > pot
    # ONE 2-operand stable sort instead of argsort + three take_along_axis
    # gathers: per-row gathers of (H, M*M) are data-dependent gathers,
    # while lax.sort co-sorts the
    # packed slot id in the same bitonic passes for free. Stable = ties keep
    # the flattened insertion order, exactly like the stable argsort before.
    sv, s_flat = jax.lax.sort((orie, p_flat), dimension=1, num_keys=1,
                              is_stable=True)
    sv, s_flat = sv[:, :pot], s_flat[:, :pot]
    s_src = s_flat % M
    s_tgt = s_flat // M
    n_pot = jnp.sum(jnp.isfinite(sv), axis=1).astype(jnp.int32)

    # circular window of width ANG_RANGE: per start i,
    #   count = #(v <= v_i + rng) - i + #(v <= v_i + rng - 2pi)
    # searchsorted(sorted, q, "right") == sum(v <= q) element-exactly (incl.
    # the all-inf masked tail: inf <= inf is True both ways). The broadcast
    # compare-and-sum is one fused elementwise reduction; jnp.searchsorted's
    # default binary-search scan lowers to 2 while loops over (H, P_POT)
    # carries.
    def window_counts(vals, n):
        hi = vals + ANG_RANGE
        c_main = jnp.sum(vals[None, :] <= hi[:, None], axis=1)
        c_wrap = jnp.sum(vals[None, :] <= (hi - 2 * math.pi)[:, None], axis=1)
        idx = jnp.arange(vals.shape[0])
        cnt = jnp.minimum(c_main, n) - idx + jnp.minimum(c_wrap, n)
        return jnp.where(idx < n, cnt, 0)

    counts = jax.vmap(window_counts)(sv, n_pot)               # (H, P_POT)
    longest = jnp.maximum(jnp.max(counts, axis=1), 1).astype(jnp.int32)
    best_beg = jnp.argmax(counts, axis=1).astype(jnp.int32)
    # no bit-adjacent pairs -> the reference's window count is 0 and check 2
    # fails unconditionally (the window extraction below would otherwise
    # fabricate a member from the all-inf sort)
    in_ang = jnp.where(n_pot > 0, longest, 0)
    pass2 = pass1 & gate2 & (n_pot > 0) & \
        (in_ang >= thres_lb.sim_constell.i_in_ang_rng)

    # window members -> fixed (H, P_MAX) constellation, anchor pair appended
    win_pos = (best_beg[:, None] + jnp.arange(P_MAX - 1)[None, :])
    win_val = jnp.arange(P_MAX - 1)[None, :] < jnp.minimum(longest, P_MAX - 1)[:, None]
    win_pos = win_pos % jnp.maximum(n_pot, 1)[:, None]
    # ONE gather of the packed flat id instead of two slot gathers, then two
    # packed-channel gathers for the pair identity instead of three: level
    # and seq ride one int32 (level*64 + seq, both < 64). Per-row gathers of
    # (H, P)-shaped outputs are separate gathers; packing removes 3.
    g_flat = jnp.take_along_axis(s_flat, win_pos, axis=1)
    g_src_slot = g_flat % M
    g_tgt_slot = g_flat // M
    src_ls = src_nei["level"] * 64 + src_nei["seq"]
    g_ls = jnp.take_along_axis(src_ls, g_src_slot, axis=1)
    pl = g_ls // 64
    ps = g_ls % 64
    pt = jnp.take_along_axis(tgt_nei["seq"], g_tgt_slot, axis=1)

    pair_level = jnp.concatenate([pl, anchor_level[:, None]], axis=1)
    pair_seq_src = jnp.concatenate([ps, anchor_seq_src[:, None]], axis=1)
    pair_seq_tgt = jnp.concatenate([pt, anchor_seq_tgt[:, None]], axis=1)
    # anchor pair goes at position `longest` (the reference appends it last);
    # move it there by building a permutation-free mask: slots [0, longest) are
    # window members, slot P_MAX-1 holds the anchor. Order only matters for the
    # shaft loop, which uses compacted positions — handled below via rank.
    pair_valid0 = jnp.concatenate([win_val, jnp.ones((H, 1), bool)], axis=1) \
        & pass2[:, None]
    # rank in the reference's cstl_in order: window members 0..longest-1, anchor = longest
    rank0 = jnp.concatenate([
        jnp.broadcast_to(jnp.arange(P_MAX - 1)[None, :], (H, P_MAX - 1)),
        longest[:, None]], axis=1).astype(jnp.int32)

    # ---- check 3: individual similarity over the constellation ----------
    # The 12 stats channels arrive PRE-PACKED (ops/descriptor.pack_tab12,
    # archived per scan as ScanDesc.tab12) so the per-pair lookup is ONE
    # gather instead of nine — the pack itself used to be rebuilt from nine
    # store gathers per cascade chunk.
    J = src_tab12.shape[2]

    def unpack12(g):
        return dict(
            cnt=g[..., 0],
            eig=jnp.stack([g[..., 1], g[..., 2]], axis=-1),
            h=g[..., 3], comr=g[..., 4],
            mean=jnp.stack([g[..., 5], g[..., 6]], axis=-1),
            vec1=jnp.stack([g[..., 7], g[..., 8]], axis=-1),
            ecc=g[..., 9] > 0.5, perc=g[..., 10], ok=g[..., 11] > 0.5)

    # lev in {1..4} -> row lev-1 ; out-of-range guarded by validity
    li = jnp.clip(pair_level - 1, 0, src_tab12.shape[1] - 1)
    s = unpack12(src_tab12[jnp.arange(H)[:, None], li,
                           jnp.clip(pair_seq_src, 0, J - 1)])   # (H, P, 12)
    t = unpack12(tgt_tab12[li, jnp.clip(pair_seq_tgt, 0, J - 1)])
    indiv = check_sim_batched(s["cnt"], s["eig"], s["h"], s["comr"],
                              t["cnt"], t["eig"], t["h"], t["comr"], cont_sim)
    cstl1 = pair_valid0 & indiv & s["ok"] & t["ok"]
    i_indiv = jnp.sum(cstl1, axis=1).astype(jnp.int32)
    gate3a = i_indiv >= thres_lb.sim_pair.i_indiv_sim

    # compacted position in cstl_in order (window order, anchor last)
    big = jnp.int32(1 << 20)
    order_rank = jnp.where(cstl1, rank0, big)
    pos_sorted = jnp.argsort(order_rank, axis=1)            # slots by rank
    inv_pos = jnp.argsort(pos_sorted, axis=1)               # slot -> compact pos
    cpos = jnp.where(cstl1, inv_pos, big)

    # ---- shaft selection quirk (contour_mng.h:1173-1184) ----------------
    # iterate (i in 1..min(n,10), j < i) over compacted positions; any span with
    # norm > current shaft norm (0 then 1 after first) replaces it ->
    # winner = last span with norm > 1, else first with norm > 0.
    mean_s = s["mean"]                                       # (H, P, 2)
    mean_t = t["mean"]
    pi_ = cpos[:, :, None]
    pj_ = cpos[:, None, :]
    elig = (pi_ < SHAFT_TOP) & (pj_ < pi_) & cstl1[:, :, None] & cstl1[:, None, :]
    span_s = mean_s[:, :, None, :] - mean_s[:, None, :, :]   # (H, P, P, 2)
    span_n = jnp.linalg.norm(span_s, axis=-1)
    it_rank = (pi_ * SHAFT_TOP + pj_).astype(jnp.int32)      # iteration order
    r_gt1 = jnp.where(elig & (span_n > 1.0), it_rank, -1)
    best_gt1 = jnp.max(r_gt1.reshape(H, -1), axis=1)
    r_gt0 = jnp.where(elig & (span_n > 0.0), it_rank, big)
    best_gt0 = jnp.min(r_gt0.reshape(H, -1), axis=1)
    use_rank = jnp.where(best_gt1 >= 0, best_gt1, best_gt0)  # (H,)
    pick = (it_rank == use_rank[:, None, None]) & elig
    # flatten pick to one (i_slot, j_slot)
    pick_f = pick.reshape(H, -1)
    pick_idx = jnp.argmax(pick_f, axis=1)
    any_pick = jnp.any(pick_f, axis=1)
    i_slot = pick_idx // cstl1.shape[1]
    j_slot = pick_idx % cstl1.shape[1]
    hidx = jnp.arange(H)
    sh_s = mean_s[hidx, i_slot] - mean_s[hidx, j_slot]
    sh_t = mean_t[hidx, i_slot] - mean_t[hidx, j_slot]
    sh_t_norm = jnp.linalg.norm(sh_t, axis=-1)
    sh_s = sh_s / jnp.maximum(jnp.linalg.norm(sh_s, axis=-1, keepdims=True), 1e-12)
    sh_t = sh_t / jnp.maximum(sh_t_norm[:, None], 1e-12)
    sh_s = jnp.where(any_pick[:, None], sh_s, 0.0)
    sh_t = jnp.where(any_pick[:, None], sh_t, 0.0)
    # a zero-length tgt span makes the reference's normalized() NaN: every
    # theta comparison is then false, so NO pair is removed (oracle parity);
    # the clamped division above would instead yield th_t = pi/2 and remove
    tgt_shaft_nan = any_pick & (sh_t_norm <= 1e-12)

    # ---- orientation screen (contour_mng.h:1186-1201) -------------------
    th_s = jnp.arccos(jnp.clip(jnp.sum(sh_s[:, None, :] * s["vec1"], axis=-1), -1.0, 1.0))
    th_t = jnp.arccos(jnp.clip(jnp.sum(sh_t[:, None, :] * t["vec1"], axis=-1), -1.0, 1.0))
    both_ecc = s["ecc"] & t["ecc"]
    bad = both_ecc & (jnp.abs(th_s - th_t) > math.pi / 6) \
        & (jnp.abs(math.pi - th_s - th_t) > math.pi / 6) \
        & ~tgt_shaft_nan[:, None]
    cstl2 = cstl1 & ~bad
    i_orie = jnp.sum(cstl2, axis=1).astype(jnp.int32)
    pass3 = pass2 & gate3a & (i_orie >= thres_lb.sim_pair.i_orie_sim)

    area_perc = jnp.where(cstl2, 0.5 * (s["perc"] + t["perc"]), 0.0)

    # ---- umeyama SE(2) (contour_mng.h:1251-1277) ------------------------
    wm = cstl2.astype(jnp.float32)
    n = jnp.maximum(wm.sum(axis=1, keepdims=True), 1.0)
    mu_s = (mean_s * wm[..., None]).sum(axis=1) / n
    mu_t = (mean_t * wm[..., None]).sum(axis=1) / n
    dt = (mean_t - mu_t[:, None]) * wm[..., None]
    C = jnp.einsum("hpi,hpj->hij", dt, mean_s - mu_s[:, None],
                   precision=jax.lax.Precision.HIGHEST)  # sum w (t-μt)(s-μs)^T
    theta = jnp.arctan2(C[:, 1, 0] - C[:, 0, 1], C[:, 0, 0] + C[:, 1, 1])
    cth, sth = jnp.cos(theta), jnp.sin(theta)
    tx = mu_t[:, 0] - (cth * mu_s[:, 0] - sth * mu_s[:, 1])
    ty = mu_t[:, 1] - (sth * mu_s[:, 0] + cth * mu_s[:, 1])
    T_delta = jnp.stack([tx, ty, theta], axis=1)

    return CascadeResult(
        pass1=pass1, pass2=pass2, pass3=pass3,
        ovlp_sum=ovlp_sum, ovlp_max_one=max_one, in_ang_rng=in_ang,
        i_indiv_sim=i_indiv, i_orie_sim=i_orie,
        pair_valid=cstl2, pair_level=pair_level, pair_seq_src=pair_seq_src,
        pair_seq_tgt=pair_seq_tgt, pair_area_perc=area_perc, T_delta=T_delta,
        pot_overflow=pot_overflow,
        win_overflow=longest > (P_MAX - 1),
    )
