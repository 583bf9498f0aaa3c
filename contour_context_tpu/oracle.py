"""NumPy reference oracle of the per-scan descriptor and check cascade.

This is a from-scratch host implementation of the *semantics* of the reference
pipeline (see SURVEY.md §2), used as (a) the test oracle for the device kernels
and (b) an exact but slow fallback. Behaviors mirrored (citations into
/root/reference):

- BEV scatter-max with continuous argmax payload        (contour_mng.h:505-556)
- hierarchical contours via per-level CC + parent gate  (contour_mng.cpp:274-353)
- ellipse stats / saliency flags                        (contour.h:142-265)
- retrieval keys with ring histogram                    (contour_mng.h:694-830)
- BCI build                                             (contour_mng.h:846-883)
- constellation consensus check                         (contour_mng.h:288-388)
- pairwise correspondence check (CLC)                   (contour_mng.h:1124-1242)
- umeyama SE(2)                                         (contour_mng.h:1251-1277)
- GMM ellipse selection / auto-corr / L2 cost           (correlation.h:42-152)

The device implementation is an independent design (dense fixed-shape tables);
this oracle exists so tests can pin down numeric contracts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from contour_context_tpu.config import (
    BITS_PER_LAYER,
    DIST_BIN_LAYERS,
    NUM_BIN_KEY_LAYER,
    RET_KEY_DIM,
    ContourManagerConfig,
    ContourSimThresConfig,
    GMMOptConfig,
    ScoreConstellSim,
    ScorePairwiseSim,
)

VAL_ABS_INF = 1e3


# ---------------------------------------------------------------------------
# BEV rasterization
# ---------------------------------------------------------------------------

@dataclass
class BevResult:
    bev: np.ndarray        # (n_row, n_col) f32 max height, -1e3 where empty
    rowf: np.ndarray       # (n_row, n_col) f32 continuous row of argmax point
    colf: np.ndarray       # (n_row, n_col) f32 continuous col of argmax point
    max_bin: float
    min_bin: float


def make_bev(points: np.ndarray, cfg: ContourManagerConfig) -> BevResult:
    """Scatter-max rasterization (contour_mng.h:505-556).

    points: (N, 3) float32 xyz in the sensor frame. Ties in height: first
    point in array order wins (strict `<` comparison in the reference).
    """
    nr, nc = cfg.n_row, cfg.n_col
    x = points[:, 0].astype(np.float64)
    y = points[:, 1].astype(np.float64)
    z = points[:, 2].astype(np.float64)
    pad = 1e-2
    x_min, x_max = -(nr / 2) * cfg.reso_row, (nr / 2) * cfg.reso_row
    y_min, y_max = -(nc / 2) * cfg.reso_col, (nc / 2) * cfg.reso_col
    ok = (
        (x >= x_min + pad) & (x <= x_max - pad)
        & (y >= y_min + pad) & (y <= y_max - pad)
        & (x * x + y * y >= cfg.blind_sq)
    )
    row = np.floor(x / cfg.reso_row).astype(np.int64) + nr // 2
    col = np.floor(y / cfg.reso_col).astype(np.int64) + nc // 2
    # reference quirk: `if (rc.first > 0)` drops row 0 (contour_mng.h:515)
    ok &= row > 0
    h = (z + cfg.lidar_height).astype(np.float32)

    bev = np.full((nr, nc), -VAL_ABS_INF, np.float32)
    rowf = np.full((nr, nc), -1.0, np.float32)
    colf = np.full((nr, nc), -1.0, np.float32)
    max_bin, min_bin = -VAL_ABS_INF, VAL_ABS_INF
    idx = np.flatnonzero(ok)
    for i in idx:
        r, c = row[i], col[i]
        if bev[r, c] < h[i]:
            bev[r, c] = h[i]
            rowf[r, c] = x[i] / cfg.reso_row + nr / 2 - 0.5
            colf[r, c] = y[i] / cfg.reso_col + nc / 2 - 0.5
        if h[i] > max_bin:
            max_bin = float(h[i])
        if h[i] < min_bin:
            min_bin = float(h[i])
    return BevResult(bev, rowf, colf, max_bin, min_bin)


# ---------------------------------------------------------------------------
# Contours (connected components + ellipse stats)
# ---------------------------------------------------------------------------

@dataclass
class Contour:
    level: int
    cell_cnt: int
    pos_mean: np.ndarray   # (2,)
    pos_cov: np.ndarray    # (2,2)
    eig_vals: np.ndarray   # (2,) ascending, clamped at point_sigma
    eig_vecs: np.ndarray   # (2,2) columns are eigenvectors
    eccen: float
    vol3_mean: float
    com: np.ndarray        # (2,)
    ecc_feat: bool
    com_feat: bool
    min_pix: int = 0       # deterministic tie-break id (min linear pixel idx)

    @property
    def manual_cov(self) -> np.ndarray:
        return self.eig_vecs @ np.diag(self.eig_vals) @ self.eig_vecs.T


def _label_8conn(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    from scipy import ndimage
    structure = np.ones((3, 3), dtype=bool)
    labels, n = ndimage.label(mask, structure=structure)
    return labels, n


def _calc_stat_vals(level: int, rr: np.ndarray, cc: np.ndarray, hh: np.ndarray,
                    cfg: ContourManagerConfig, min_pix: int) -> Contour:
    """ContourView::calcStatVals (contour.h:142-255) from per-cell samples."""
    sc = cfg.view_stat
    n = len(rr)
    pos_sum = np.array([rr.sum(), cc.sum()], np.float64)
    mean = (pos_sum / n).astype(np.float32)
    vol3 = float(hh.sum())
    vol3_mean = np.float32(vol3 / n)
    com = (np.array([(hh * rr).sum(), (hh * cc).sum()]) / vol3).astype(np.float32)

    if n < sc.min_cell_cov:
        cov = np.eye(2, dtype=np.float32) * sc.point_sigma ** 2
        eig_vals = np.array([sc.point_sigma, sc.point_sigma], np.float32)
        eig_vecs = np.eye(2, dtype=np.float32)
        eccen = 0.0
        ecc_feat = com_feat = False
    else:
        tss = np.zeros((2, 2), np.float64)
        tss[0, 0] = (rr * rr).sum()
        tss[0, 1] = tss[1, 0] = (rr * cc).sum()
        tss[1, 1] = (cc * cc).sum()
        cov = ((tss.astype(np.float32) - np.outer(mean, mean) * n) / (n - 1)).astype(np.float32)
        w, v = np.linalg.eigh(cov.astype(np.float64))
        eig_vals = np.maximum(w, sc.point_sigma).astype(np.float32)
        eig_vecs = v.astype(np.float32)
        eccen = float(np.sqrt(eig_vals[1] ** 2 - eig_vals[0] ** 2) / eig_vals[1])
        # eccentricitySalient (contour.h:258-260): strict '>' on the perc diff
        ecc_feat = bool(
            n > 5
            and abs((eig_vals[0] - eig_vals[1]) / max(eig_vals[0], eig_vals[1])) > 0.2
            and eig_vals[1] > 2.5
        )
        com_feat = bool(np.linalg.norm(com - mean) > sc.com_bias_thres)
    return Contour(level, n, mean, cov, eig_vals, eig_vecs, eccen, vol3_mean,
                   com, ecc_feat, com_feat, min_pix)


def extract_contours(bev: BevResult, cfg: ContourManagerConfig) -> Tuple[List[List[Contour]], List[int]]:
    """Per-level contour tables, sorted by (cell count desc, min pixel asc).

    Equivalent to makeContourRecursiveHelper's recursion (contour_mng.cpp:274-353):
    levels are nested, so labeling each level independently on the full image
    and gating validity on the parent component's validity reproduces the
    recursive masking, including the min_cont_cell_cnt recursion cut-off.
    Returns (cont_views per level, layer_cell_cnt per level).
    """
    nr, nc = cfg.n_row, cfg.n_col
    n_lev = cfg.n_levels
    labels_per_level = []
    for ll in range(n_lev):
        mask = bev.bev > cfg.lv_grads[ll]
        labels, _ = _label_8conn(mask)
        labels_per_level.append(labels)

    cont_views: List[List[Contour]] = []
    layer_cell_cnt: List[int] = []
    valid_prev: Optional[dict] = None  # label -> valid at previous level
    for ll in range(n_lev):
        labels = labels_per_level[ll]
        conts: List[Contour] = []
        valid_now: dict = {}
        for lab in range(1, labels.max() + 1):
            ys, xs = np.nonzero(labels == lab)
            cnt = len(ys)
            if cnt == 0:
                continue
            ok = cnt >= cfg.min_cont_cell_cnt
            if ll > 0 and ok:
                parent_lab = labels_per_level[ll - 1][ys[0], xs[0]]
                ok = valid_prev.get(int(parent_lab), False)
            valid_now[lab] = ok
            if not ok:
                continue
            rr = bev.rowf[ys, xs].astype(np.float64)
            cc = bev.colf[ys, xs].astype(np.float64)
            hh = bev.bev[ys, xs].astype(np.float64)
            min_pix = int((ys * nc + xs).min())
            conts.append(_calc_stat_vals(ll, rr, cc, hh, cfg, min_pix))
        valid_prev = valid_now
        conts.sort(key=lambda c: (-c.cell_cnt, c.min_pix))
        cont_views.append(conts)
        layer_cell_cnt.append(sum(c.cell_cnt for c in conts))
    return cont_views, layer_cell_cnt


# ---------------------------------------------------------------------------
# Retrieval keys + BCIs
# ---------------------------------------------------------------------------

@dataclass
class OracleBCI:
    level: int
    piv_seq: int
    bits: np.ndarray           # (256,) bool
    # neighbor table sorted by (bit_pos, layer-gen order)
    nei_level: np.ndarray      # (M,) int
    nei_seq: np.ndarray        # (M,) int
    nei_bit: np.ndarray        # (M,) int
    nei_r: np.ndarray          # (M,) float
    nei_theta: np.ndarray      # (M,) float


def make_keys_and_bcis(bev: BevResult, cont_views: List[List[Contour]],
                       cfg: ContourManagerConfig):
    """Retrieval key + BCI per (level, anchor seq) (contour_mng.h:689-895)."""
    n_lev = cfg.n_levels
    keys = np.zeros((n_lev, cfg.piv_firsts, RET_KEY_DIM), np.float32)
    bcis: List[List[Optional[OracleBCI]]] = [[None] * cfg.piv_firsts for _ in range(n_lev)]

    num_bins = RET_KEY_DIM - 3
    bin_len = cfg.roi_radius / num_bins
    div_per_bin = 5
    div_len = cfg.roi_radius / (num_bins * div_per_bin)
    div_centers = np.arange(num_bins * div_per_bin) * div_len + 0.5 * div_len
    roi_pad = int(math.ceil(cfg.roi_radius + 1))
    h_gate = cfg.lv_grads[DIST_BIN_LAYERS[0]]

    # pixel pool above the gate level
    ys, xs = np.nonzero(bev.bev > h_gate)
    pix_rowf = bev.rowf[ys, xs]
    pix_colf = bev.colf[ys, xs]
    pix_h = bev.bev[ys, xs]
    higher_cnt = np.zeros(len(ys), np.int32)
    for ele in range(DIST_BIN_LAYERS[0], n_lev):
        higher_cnt += (pix_h > cfg.lv_grads[ele]).astype(np.int32)

    for ll in range(n_lev):
        accumulate_cell_cnt = 0
        for seq in range(cfg.piv_firsts):
            if len(cont_views[ll]) > seq:
                accumulate_cell_cnt += cont_views[ll][seq].cell_cnt
            if not (len(cont_views[ll]) > seq
                    and cont_views[ll][seq].cell_cnt >= cfg.min_cont_key_cnt):
                continue
            anchor = cont_views[ll][seq]
            v_cen = anchor.pos_mean
            r_cen, c_cen = int(v_cen[0]), int(v_cen[1])
            in_box = (
                (ys >= max(0, r_cen - roi_pad)) & (ys <= min(cfg.n_row - 1, r_cen + roi_pad))
                & (xs >= max(0, c_cen - roi_pad)) & (xs <= min(cfg.n_col - 1, c_cen + roi_pad))
            )
            dist = np.hypot(pix_rowf - v_cen[0], pix_colf - v_cen[1])
            contrib = in_box & (dist < cfg.roi_radius - 1e-2)
            cnt_point = int(contrib.sum())
            divs = np.zeros(num_bins * div_per_bin, np.float64)
            if cnt_point:
                d = dist[contrib][:, None]
                w = higher_cnt[contrib][:, None].astype(np.float64)
                g = np.exp(-0.5 * (div_centers[None, :] - d) ** 2) / math.sqrt(2 * math.pi)
                divs = (w * g).sum(axis=0)
            ring = divs.reshape(num_bins, div_per_bin).sum(axis=1)
            if cnt_point:
                ring = ring * bin_len / math.sqrt(cnt_point)

            key = np.zeros(RET_KEY_DIM, np.float32)
            key[0] = math.sqrt(anchor.eig_vals[1] * anchor.cell_cnt)
            key[1] = math.sqrt(anchor.eig_vals[0] * anchor.cell_cnt)
            key[2] = math.sqrt(accumulate_cell_cnt)
            key[3:] = ring
            keys[ll, seq] = key

            # BCI (contour_mng.h:846-883)
            bits = np.zeros(BITS_PER_LAYER * NUM_BIN_KEY_LAYER, bool)
            nl, ns, nb, nr_, nt = [], [], [], [], []
            for bl in range(NUM_BIN_KEY_LAYER):
                lay = DIST_BIN_LAYERS[bl]
                bit_offset = bl * BITS_PER_LAYER
                for j in range(min(cfg.dist_firsts, len(cont_views[lay]))):
                    if lay == ll and j == seq:
                        continue
                    vec = cont_views[lay][j].pos_mean - anchor.pos_mean
                    d = float(np.hypot(vec[0], vec[1]))
                    if d > (BITS_PER_LAYER - 1) * 1.01 + 5.43 - 1e-3 or d <= 5.43:
                        continue
                    bit = int(min(math.floor((d - 5.43) / 1.01), BITS_PER_LAYER - 1.0)) + bit_offset
                    bits[bit] = True
                    nl.append(lay); ns.append(j); nb.append(bit)
                    nr_.append(d); nt.append(math.atan2(vec[1], vec[0]))
            order = np.argsort(np.asarray(nb, np.int64), kind="stable")
            bcis[ll][seq] = OracleBCI(
                ll, seq, bits,
                np.asarray(nl, np.int32)[order], np.asarray(ns, np.int32)[order],
                np.asarray(nb, np.int32)[order], np.asarray(nr_, np.float32)[order],
                np.asarray(nt, np.float32)[order],
            )
    return keys, bcis


# ---------------------------------------------------------------------------
# Full per-scan descriptor
# ---------------------------------------------------------------------------

@dataclass
class OracleScan:
    cfg: ContourManagerConfig
    bev: BevResult
    cont_views: List[List[Contour]]
    layer_cell_cnt: List[int]
    keys: np.ndarray
    bcis: list
    int_id: int = -1

    def cont_perc(self, lev: int, seq: int) -> float:
        return self.cont_views[lev][seq].cell_cnt / max(1, self.layer_cell_cnt[lev])


def build_scan(points: np.ndarray, cfg: ContourManagerConfig, int_id: int = -1) -> OracleScan:
    bev = make_bev(points, cfg)
    cont_views, layer_cell_cnt = extract_contours(bev, cfg)
    keys, bcis = make_keys_and_bcis(bev, cont_views, cfg)
    return OracleScan(cfg, bev, cont_views, layer_cell_cnt, keys, bcis, int_id)


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def _diff_perc(a: float, b: float, perc: float) -> bool:
    return abs((a - b) / max(a, b)) > perc


def _diff_delt(a: float, b: float, delta: float) -> bool:
    return abs(a - b) > delta


def check_sim(cs: Contour, ct: Contour, th: ContourSimThresConfig) -> bool:
    """ContourView::checkSim (contour.h:278-329)."""
    if _diff_perc(cs.cell_cnt, ct.cell_cnt, th.tp_cell_cnt) and \
       _diff_delt(cs.cell_cnt, ct.cell_cnt, th.ta_cell_cnt):
        return False
    if max(cs.eig_vals[1], ct.eig_vals[1]) > 2.0 and \
       _diff_perc(math.sqrt(cs.eig_vals[1]), math.sqrt(ct.eig_vals[1]), th.tp_eigval):
        return False
    if max(cs.eig_vals[0], ct.eig_vals[0]) > 2.0 and \
       _diff_perc(math.sqrt(cs.eig_vals[0]), math.sqrt(ct.eig_vals[0]), th.tp_eigval):
        return False
    if max(cs.cell_cnt, ct.cell_cnt) > 15 and \
       _diff_delt(cs.vol3_mean, ct.vol3_mean, th.ta_h_bar):
        return False
    r1 = float(np.linalg.norm(cs.com - cs.pos_mean))
    r2 = float(np.linalg.norm(ct.com - ct.pos_mean))
    if _diff_delt(r1, r2, th.ta_rcom) and _diff_perc(r1, r2, th.tp_rcom):
        return False
    return True


def _clamp_ang(a: float) -> float:
    return a - math.floor((a + math.pi) / (2 * math.pi)) * 2 * math.pi


def check_constell_sim(src: OracleBCI, tgt: OracleBCI, lb: ScoreConstellSim):
    """BCI::checkConstellSim (contour_mng.h:288-388).

    Returns (ScoreConstellSim counts as tuple, constell pairs list
    [(level, seq_src, seq_tgt)] or None if failed).
    """
    b_s, b_t = src.bits, tgt.bits
    and1 = int((b_s & b_t).sum())
    # bitset << 1: bit i set in result iff bit i-1 set in src (whole 256-bit word)
    sl = np.concatenate([[False], b_s[:-1]])
    sr = np.concatenate([b_s[1:], [False]])
    and2 = int((sl & b_t).sum())
    and3 = int((sr & b_t).sum())
    ovlp_sum = and1 + and2 + and3
    max_one = max(and1, and2, and3)
    score = [ovlp_sum, max_one, 0]
    if not (ovlp_sum >= lb.i_ovlp_sum and max_one >= lb.i_ovlp_max_one):
        return score, None

    # potential pairs: src/tgt neighbors whose bits differ by at most 1
    pot = []  # (orie_diff, level, seq_src, seq_tgt)
    for i in range(len(tgt.nei_bit)):
        tb = tgt.nei_bit[i]
        close = np.abs(src.nei_bit - tb) <= 1
        for j in np.flatnonzero(close):
            pot.append((
                _clamp_ang(float(tgt.nei_theta[i]) - float(src.nei_theta[j])),
                int(src.nei_level[j]), int(src.nei_seq[j]), int(tgt.nei_seq[i]),
            ))
    if not pot:
        return score, None
    pot.sort(key=lambda t: t[0])

    ang_rng = math.pi / 16
    n = len(pot)
    longest, longest_beg = 1, 0
    p1 = p2 = 0
    while p1 < n:
        if pot[p2 % n][0] - pot[p1][0] + 2 * math.pi * (p2 // n) > ang_rng:
            p1 += 1
        else:
            if p2 - p1 + 1 > longest:
                longest = p2 - p1 + 1
                longest_beg = p1
            p2 += 1
    score[2] = longest
    if longest < lb.i_in_ang_rng:
        return score, None
    pairs = [(pot[i % n][1], pot[i % n][2], pot[i % n][3])
             for i in range(longest_beg, longest_beg + longest)]
    pairs.append((src.level, src.piv_seq, tgt.piv_seq))
    return score, pairs


def check_constell_corresp_sim(src: OracleScan, tgt: OracleScan, cstl_in,
                               lb: ScorePairwiseSim, th: ContourSimThresConfig):
    """ContourManager::checkConstellCorrespSim (contour_mng.h:1124-1242).

    Returns (score tuple [i_indiv, i_orie], cstl_out, area_perc) — cstl_out is
    None when a bar is not met.
    """
    cstl_out = []
    for (lev, ss, st) in cstl_in:
        if check_sim(src.cont_views[lev][ss], tgt.cont_views[lev][st], th):
            cstl_out.append((lev, ss, st))
    score = [len(cstl_out), 0]
    if score[0] < lb.i_indiv_sim:
        return score, None, None

    # shaft selection quirk (contour_mng.h:1173-1184): any pair whose src-side
    # span is longer than the *normalized* current shaft (norm 1 after first
    # assignment) replaces it — i.e. the last span with norm > 1 wins.
    shaft_src = np.zeros(2, np.float32)
    shaft_tgt = np.zeros(2, np.float32)
    cur_norm = 0.0
    for i in range(1, min(len(cstl_out), 10)):
        for j in range(i):
            li, si, ti = cstl_out[i]
            lj, sj, tj = cstl_out[j]
            cs = src.cont_views[li][si].pos_mean - src.cont_views[lj][sj].pos_mean
            if np.linalg.norm(cs) > cur_norm:
                shaft_src = cs / np.linalg.norm(cs)
                ctv = tgt.cont_views[li][ti].pos_mean - tgt.cont_views[lj][tj].pos_mean
                with np.errstate(invalid="ignore"):
                    # coincident tgt means -> nan shaft, faithfully failing
                    # the orientation screen like the reference's normalized()
                    shaft_tgt = ctv / np.linalg.norm(ctv)
                cur_norm = 1.0

    # orientation screen with swap-removal (contour_mng.h:1186-1201)
    out = list(cstl_out)
    num_sim = len(out)
    i = 0
    while i < num_sim:
        lev, ss, st = out[i]
        sc1 = src.cont_views[lev][ss]
        tc1 = tgt.cont_views[lev][st]
        if sc1.ecc_feat and tc1.ecc_feat:
            ths_ = math.acos(np.clip(shaft_src @ sc1.eig_vecs[:, 1], -1.0, 1.0))
            tht_ = math.acos(np.clip(shaft_tgt @ tc1.eig_vecs[:, 1], -1.0, 1.0))
            if _diff_delt(ths_, tht_, math.pi / 6) and _diff_delt(math.pi - ths_, tht_, math.pi / 6):
                out[i], out[num_sim - 1] = out[num_sim - 1], out[i]
                num_sim -= 1
                continue
        i += 1
    out = out[:num_sim]
    score[1] = len(out)
    if score[1] < lb.i_orie_sim:
        return score, None, None
    area_perc = [0.5 * (src.cont_perc(lev, ss) + tgt.cont_perc(lev, st))
                 for (lev, ss, st) in out]
    return score, out, area_perc


def umeyama_se2(src: OracleScan, tgt: OracleScan, pairs) -> np.ndarray:
    """getTFFromConstell (contour_mng.h:1251-1277): rigid 2-D umeyama."""
    ps = np.stack([src.cont_views[l][s].pos_mean for (l, s, t) in pairs]).astype(np.float64)
    pt = np.stack([tgt.cont_views[l][t].pos_mean for (l, s, t) in pairs]).astype(np.float64)
    mu_s, mu_t = ps.mean(0), pt.mean(0)
    H = (pt - mu_t).T @ (ps - mu_s)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    R = U @ np.diag([1.0, d]) @ Vt
    th = math.atan2(R[1, 0], R[0, 0])
    Rc = np.array([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]])
    t = mu_t - Rc @ mu_s
    T = np.eye(3)
    T[:2, :2] = Rc
    T[:2, 2] = t
    return T


# ---------------------------------------------------------------------------
# GMM L2 correlation
# ---------------------------------------------------------------------------

@dataclass
class GmmModel:
    """Per-scan GMM ellipse set over the configured levels (correlation.h:49-82)."""
    mus: List[np.ndarray]      # per level: (E, 2)
    covs: List[np.ndarray]     # per level: (E, 2, 2) manual (reconstructed) cov
    ws: List[np.ndarray]       # per level: (E,)
    majax: List[np.ndarray]    # per level: (E,) sqrt(lambda_max)
    auto_corr: float = 0.0


def build_gmm(scan: OracleScan, cfg: GMMOptConfig) -> GmmModel:
    mus, covs, ws, majax = [], [], [], []
    for lev in cfg.levels:
        full = scan.layer_cell_cnt[lev]
        run = 0
        m, c, w, a = [], [], [], []
        for cont in scan.cont_views[lev]:
            if full > 0 and run * 1.0 / full >= cfg.min_area_perc:
                break
            m.append(cont.pos_mean.astype(np.float64))
            c.append(cont.manual_cov.astype(np.float64))
            w.append(float(cont.cell_cnt))
            a.append(math.sqrt(cont.eig_vals[1]))
            run += cont.cell_cnt
        mus.append(np.asarray(m).reshape(-1, 2))
        covs.append(np.asarray(c).reshape(-1, 2, 2))
        ws.append(np.asarray(w))
        majax.append(np.asarray(a))
    ac = 0.0
    for li in range(len(cfg.levels)):
        mu, cv, w = mus[li], covs[li], ws[li]
        for i in range(len(w)):
            for j in range(len(w)):
                S = cfg.cov_dilate_scale * (cv[i] + cv[j])
                dmu = mu[i] - mu[j]
                ac += w[i] * w[j] / math.sqrt(np.linalg.det(S)) * \
                    math.exp(-0.5 * dmu @ np.linalg.inv(S) @ dmu)
    return GmmModel(mus, covs, ws, majax, ac)


def gmm_select_pairs(src: GmmModel, tgt: GmmModel, T_init: np.ndarray, cfg: GMMOptConfig):
    """Pre-select close pairs (correlation.h:85-96). Returns per-level index pairs."""
    R, t = T_init[:2, :2], T_init[:2, 2]
    sel = []
    for li in range(len(src.mus)):
        prs = []
        for si in range(len(src.ws[li])):
            for ti in range(len(tgt.ws[li])):
                dmu = R @ src.mus[li][si] + t - tgt.mus[li][ti]
                if np.linalg.norm(dmu) < 3.0 * (src.majax[li][si] + tgt.majax[li][ti]):
                    prs.append((si, ti))
        sel.append(prs)
    return sel


def gmm_cost(src: GmmModel, tgt: GmmModel, sel, params, cfg: GMMOptConfig) -> float:
    """The Ceres cost functor (correlation.h:125-152): negative L2 inner product."""
    x, y, th = params
    R = np.array([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]])
    t = np.array([x, y])
    cost = 0.0
    for li in range(len(sel)):
        for (si, ti) in sel[li]:
            S = cfg.cov_dilate_scale * (R @ src.covs[li][si] @ R.T + tgt.covs[li][ti])
            mu = R @ src.mus[li][si] + t - tgt.mus[li][ti]
            cost += -src.ws[li][si] * tgt.ws[li][ti] / math.sqrt(np.linalg.det(S)) * \
                math.exp(-0.5 * mu @ np.linalg.inv(S) @ mu)
    return cost


def gmm_correlation(src: GmmModel, tgt: GmmModel, sel, params, cfg: GMMOptConfig) -> float:
    denom = math.sqrt(src.auto_corr * tgt.auto_corr)
    if denom <= 0:
        return 0.0
    return -gmm_cost(src, tgt, sel, params, cfg) / denom


# ---------------------------------------------------------------------------
# TreeBucket / LayerDB pop-schedule replica (temporal-window STAGGER spec)
# ---------------------------------------------------------------------------
# The reference makes keys searchable through per-bucket buffers popped one
# adjacent bucket PAIR per scan on a triangle-wave schedule
# (ContourDB::pushAndBalance, contour_db.h:827-843; LayerDB::rebuild,
# contour_db.cpp:63-317; TreeBucket buffering, contour_db.h:102-143). The device
# DB replaces this with a single global searchable prefix
# (db._update_window_impl). This replica exists so a test can DRIVE both
# models over a long trace and bound their searchable-set divergence
# (tests/test_window_stagger.py).
#
# Faithfully replicated: bucket ranges evolving through rebalance splits
# (incl. the contagious-value search), buffer redistribution across the new
# split, per-bucket needPopBuffer/popBufferMax timing, and the triangle-wave
# pair schedule. Only key[0] (bucket_chann_, contour_db.h:163) matters for
# scheduling, so entries are (k0, ts, id) triples.

MAX_BUCKET_VAL = 1000.0        # contour_db.h:29
MIN_ELEM_SPLIT = 100           # contour_db.h:160
IMBA_DIFF_RATIO = 0.2          # contour_db.h:161
NUM_BUCKETS = 6                # contour_db.h:162


class RefLayerDB:
    """One LayerDB: 6 TreeBuckets over key[0] ranges (contour_db.h:159-217)."""

    def __init__(self, min_elapse: float = 15.0, max_elapse: float = 25.0):
        self.min_elapse = min_elapse
        self.max_elapse = max_elapse
        # bucket_ranges_: [-MAX, MAX, MAX, ..., MAX] (contour_db.h:168-178)
        self.ranges = [-MAX_BUCKET_VAL] + [MAX_BUCKET_VAL] * NUM_BUCKETS
        self.tree = [[] for _ in range(NUM_BUCKETS)]   # popped (k0, id)
        self.buf = [[] for _ in range(NUM_BUCKETS)]    # buffered (k0, ts, id)
        # divergence instrumentation (not in the reference): the driver may
        # set `clock` to the current scan index; each buffer->tree pop
        # records it, so tests can compare per-key searchability timing
        # against the device DB's global-prefix model without O(N^2) set diffs
        self.clock = -1
        self.pop_log = {}                              # id -> clock at pop

    def push_buffer(self, k0: float, ts: float, ident) -> None:
        """LayerDB::pushBuffer (contour_db.h:184-192): route by range."""
        for i in range(NUM_BUCKETS):
            if self.ranges[i] <= k0 < self.ranges[i + 1]:
                self.buf[i].append((k0, ts, ident))
                return

    def _need_pop(self, b: int, ts: float) -> bool:
        """TreeBucket::needPopBuffer (contour_db.h:102-107)."""
        return bool(self.buf[b]) and self.buf[b][0][1] <= ts - self.max_elapse

    def _pop_max(self, b: int, ts: float) -> None:
        """TreeBucket::popBufferMax (contour_db.h:121-143): move entries with
        ts < cutoff into the tree (buffer is ts-sorted)."""
        cut = ts - self.min_elapse
        gap = 0
        while gap < len(self.buf[b]) and self.buf[b][gap][1] < cut:
            gap += 1
        for k0, _, ident in self.buf[b][:gap]:
            self.tree[b].append((k0, ident))
            self.pop_log[ident] = self.clock
        del self.buf[b][:gap]

    def rebuild(self, idx: int, ts: float) -> None:
        """LayerDB::rebuild (contour_db.cpp:63-317) on buckets idx, idx+1."""
        pb1, pb2 = self._need_pop(idx, ts), self._need_pop(idx + 1, ts)
        if not pb1 and not pb2:
            return
        sz1, sz2 = len(self.tree[idx]), len(self.tree[idx + 1])
        diff_ratio = abs(sz1 - sz2) / max(sz1, sz2) if max(sz1, sz2) else 0.0
        small = diff_ratio < IMBA_DIFF_RATIO or max(sz1, sz2) < MIN_ELEM_SPLIT
        if pb1 and not pb2 and small:
            self._pop_max(idx, ts)
            return
        if not pb1 and pb2 and small:
            self._pop_max(idx + 1, ts)
            return
        if diff_ratio < 0.5 * IMBA_DIFF_RATIO:
            if pb1:
                self._pop_max(idx, ts)
            if pb2:
                self._pop_max(idx + 1, ts)
            return
        # balance: move ~half the surplus across a split value, avoiding
        # splitting runs of equal k0 ("contagious values",
        # contour_db.cpp:100-298); then redistribute buffers and pop both
        if sz1 > sz2:
            src, dst, big = idx, idx + 1, self.tree[idx]
        else:
            src, dst, big = idx + 1, idx, self.tree[idx + 1]
        n_big, n_small = max(sz1, sz2), min(sz1, sz2)
        to_move_max = int((n_big - n_small + IMBA_DIFF_RATIO * n_small)
                          / (2 - IMBA_DIFF_RATIO))
        to_move_mid = int((n_big - n_small) / 2.0)
        to_move_min = max(0, int((n_big - n_small - IMBA_DIFF_RATIO * n_big)
                                 / (2 - IMBA_DIFF_RATIO)))
        if to_move_mid == 0:
            # size diff <= 1: the C++ would read sort_permu[sz1] past the end
            # (UB, contour_db.cpp:117-118; reachable when both buckets need a
            # pop and the trees are tiny, so the min_elem_split_ guard at
            # contour_db.cpp:78-86 is bypassed). Define it as unsplittable and
            # pop both, mirroring the contagious-strip handling below.
            if pb1 or src == idx:
                self._pop_max(idx, ts)
            if pb2 or src == idx + 1:
                self._pop_max(idx + 1, ts)
            return
        # keys of the big bucket nearest the split move first: sort ascending
        # by k0; moving from the high side when src < dst index-wise means
        # src has the LOWER range (tr1) -> move its LARGEST keys, and vice
        # versa (the two C++ branches sort in opposite directions)
        order = sorted(range(n_big), key=lambda i: big[i][0],
                       reverse=(src > dst))
        # order[n_big - 1 - j] is the j-th key to move (the C++ walks
        # sort_permu from the back)
        kv = lambda j: big[order[n_big - j]][0]
        num_to_move = 0
        split_val = None
        if kv(to_move_mid) != kv(to_move_mid + 1):
            num_to_move = to_move_mid
            # tr1 keeps ( , split], tr2 gets [split, ): the split value is
            # the first moved key when moving upward, the last kept when
            # moving downward (contour_db.cpp:115-118 vs 209-211)
            split_val = kv(to_move_mid) if src < dst else kv(to_move_mid + 1)
        else:
            contagious = kv(to_move_mid)
            i = to_move_mid - 1
            while i > to_move_min:
                if kv(i) != contagious:
                    num_to_move = i
                    split_val = kv(i) if src < dst else contagious
                    break
                i -= 1
            if num_to_move == 0:
                i = to_move_mid + 1
                while i < to_move_max:
                    if kv(i) != contagious:
                        num_to_move = i - 1
                        split_val = contagious if src < dst else kv(i)
                        break
                    i += 1
        if num_to_move == 0:
            # cannot split a contagious strip (contour_db.cpp:138-147)
            if pb1 or src == idx:
                self._pop_max(idx, ts)
            if pb2 or src == idx + 1:
                self._pop_max(idx + 1, ts)
            return
        moved = [order[n_big - 1 - j] for j in range(num_to_move)]
        moved_set = set(moved)
        self.tree[dst].extend(big[i] for i in moved)
        self.tree[src] = [e for i, e in enumerate(big) if i not in moved_set]
        # buffer redistribution across the new split (contour_db.cpp:168-188)
        if src < dst:
            keep = [e for e in self.buf[src] if e[0] < split_val]
            move = [e for e in self.buf[src] if e[0] >= split_val]
        else:
            keep = [e for e in self.buf[src] if e[0] >= split_val]
            move = [e for e in self.buf[src] if e[0] < split_val]
        self.buf[src] = sorted(keep, key=lambda e: e[1])
        self.buf[dst] = sorted(self.buf[dst] + move, key=lambda e: e[1])
        self.ranges[idx + 1] = split_val
        self._pop_max(idx, ts)
        self._pop_max(idx + 1, ts)

    def searchable_ids(self) -> set:
        return {ident for b in self.tree for _, ident in b}


def triangle_pair_index(seed: int) -> int:
    """pushAndBalance's bucket-pair schedule (contour_db.h:828-830):
    0,1,2,3,4,3,2,1,0,1,... (period 8 for 6 buckets)."""
    idx = abs(seed) % (2 * (NUM_BUCKETS - 2))
    if idx > NUM_BUCKETS - 2:
        idx = 2 * (NUM_BUCKETS - 2) - idx
    return idx
