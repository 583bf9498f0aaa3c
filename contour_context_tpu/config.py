"""All configuration knobs of the framework, promoted into dataclasses.

The reference scatters knobs over a YAML file (`config/batch_bin_test_config.yaml`),
compile-time macros (`CMakeLists.txt:15-21`) and hardcoded constants
(`contour_mng.h:112-115`, `correlation.h:17-18`, `contour_db.h:160-163`).  Here every
knob lives in one place; the hardcoded ones keep their reference defaults.

Reference parity notes are given as `file:line` citations into the reference repo.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# Fixed-shape capacity constants for the device dense-array layout.
# The reference uses variable-size std::vector everywhere; on the device every
# per-scan structure is a fixed-shape dense array with validity masks.  These caps bound
# the dense axes.  They are deliberately generous; truncation beyond them is
# counted and reported by the pipeline.
# ---------------------------------------------------------------------------

MAX_CONTOURS_PER_LEVEL = 64   # contours kept per height level (ref keeps all; sorted desc by cell count)
MAX_NEIGHBORS = 40            # BCI neighbor stars: 4 layers x dist_firsts(10) (contour_mng.h:846-868)
MAX_PAIR_CANDS = 256          # potential constellation pairs per BCI check (two-pointer pool)
MAX_CSTL_PAIRS = 64           # constellation pairs kept after windowing (+1 anchor pair)
BITS_PER_LAYER = 64           # contour_mng.h:112
DIST_BIN_LAYERS = (1, 2, 3, 4)  # contour_mng.h:113
LAYER_AREA_WEIGHTS = (0.3, 0.3, 0.3, 0.1)  # contour_mng.h:114
NUM_BIN_KEY_LAYER = len(DIST_BIN_LAYERS)
BCI_BITS = BITS_PER_LAYER * NUM_BIN_KEY_LAYER  # 256
RET_KEY_DIM = 10              # contour_mng.h:89


@dataclass(frozen=True)
class ContourViewStatConfig:
    """Per-contour statistics knobs (contour.h:32-37)."""
    min_cell_cov: int = 4
    point_sigma: float = 1.0
    com_bias_thres: float = 0.5


@dataclass(frozen=True)
class ContourSimThresConfig:
    """Pairwise contour similarity gate thresholds (contour.h:40-45)."""
    ta_cell_cnt: float = 6.0
    tp_cell_cnt: float = 0.2
    tp_eigval: float = 0.2
    ta_h_bar: float = 0.3      # 0.75 for MulRan
    ta_rcom: float = 0.4
    tp_rcom: float = 0.25


@dataclass(frozen=True)
class ContourManagerConfig:
    """Per-scan BEV / contour / key extraction knobs (contour_mng.h:92-110)."""
    lv_grads: Tuple[float, ...] = (1.5, 2.0, 2.5, 3.0, 3.5, 4.0)  # KITTI; MulRan: (1,2.5,4,5.5,7,8.5)
    reso_row: float = 1.0
    reso_col: float = 1.0
    n_row: int = 150
    n_col: int = 150
    lidar_height: float = 2.0
    blind_sq: float = 9.0
    min_cont_key_cnt: int = 9
    min_cont_cell_cnt: int = 3
    piv_firsts: int = 6
    dist_firsts: int = 10
    roi_radius: float = 10.0
    # device capacity knobs (not in reference; dense-table bounds)
    max_contours: int = MAX_CONTOURS_PER_LEVEL
    max_points: int = 131072   # point-cloud pad size (KITTI HDL-64E: ~120-130k)
    pix_pool: int = 4096       # above-gate pixel pool for the ring keys
                               # (KITTI-style scenes occupy ~2-6k of 22.5k cells)
    keys_bf16: bool = True     # keep the DB's SEARCH-LAYOUT key copy
                               # (ContourDB.keys_q) bfloat16: halves the
                               # bytes the city-scale search streams. The
                               # archived ScanDesc.keys stay exact f32
                               # (oracle + checkpoint chain unaffected); only
                               # key-hit RANKING near the distance bound
                               # rounds, and the cascade re-verifies every
                               # survivor exactly. Paired with
                               # topk_strategy="cover2" (the two were chosen
                               # together)
    cc_flush: str = "hillis"   # segmented run-flush lowering in cc_labels:
                               # "hillis" = Hillis-Steele doubling shift+max
                               # (2 ops x log2(n) steps per direction) +
                               # separable shift-based 3x3 window min;
                               # "scan" = lax.associative_scan odd-even
                               # recursion + lax.reduce_window. Label-
                               # identical (the fixpoint is lowering-
                               # independent; tests pin element equality) —
                               # a pure speed knob; "hillis" issues fewer ops
    view_stat: ContourViewStatConfig = field(default_factory=ContourViewStatConfig)

    def __post_init__(self):
        # the dense check-3 tables and BCI pair-slot encoding hold 10 seqs
        # (the reference's dist_firsts default); larger values would silently
        # alias slots — reject loudly (db._tab_from, ops/candidate.N_SEQ)
        if self.dist_firsts > 10:
            raise ValueError("dist_firsts > 10 is not supported by the dense "
                             "pair-slot layout (see ops/candidate.N_SEQ)")
        if self.piv_firsts > 10:
            raise ValueError("piv_firsts > 10 exceeds the pair-slot layout")
        # ScanDesc.cnt is stored int16: a single connected component is
        # bounded by the grid cell count, which must fit
        if self.n_row * self.n_col > 32767:
            raise ValueError(
                "n_row * n_col > 32767 overflows the int16 cell counts of "
                "the archived store (types.ScanDesc.cnt)")

    @property
    def n_levels(self) -> int:
        return len(self.lv_grads)


@dataclass(frozen=True)
class TreeBucketConfig:
    """Temporal insertion-delay window (contour_db.h:54-57)."""
    max_elapse: float = 25.0
    min_elapse: float = 15.0


@dataclass(frozen=True)
class GMMOptConfig:
    """GMM L2 correlation knobs (correlation.h:15-20)."""
    min_area_perc: float = 0.95
    levels: Tuple[int, ...] = (1, 2, 3, 4)
    cov_dilate_scale: float = 2.0
    # device capacity knobs
    max_gmm_ellipses: int = 32   # per level, ellipses kept to reach min_area_perc
    gn_iters: int = 10           # ceres: max_num_iterations=10 (correlation.h:215)


# --- score ensembles --------------------------------------------------------
# The reference packs these in unions (contour_mng.h:121-219); here plain dataclasses.

@dataclass(frozen=True)
class ScoreConstellSim:
    """BCI constellation consensus score (contour_mng.h:121-152)."""
    i_ovlp_sum: int = 3
    i_ovlp_max_one: int = 3
    i_in_ang_rng: int = 3

    def overall(self) -> int:
        return self.i_in_ang_rng


@dataclass(frozen=True)
class ScorePairwiseSim:
    """Pairwise correspondence score (contour_mng.h:154-186)."""
    i_indiv_sim: int = 3
    i_orie_sim: int = 4

    def overall(self) -> int:
        return self.i_orie_sim


@dataclass(frozen=True)
class ScorePostProc:
    """Post-processing screens (contour_mng.h:188-219)."""
    correlation: float = 0.3
    area_perc: float = 0.03
    neg_est_dist: float = -5.01

    def overall(self) -> float:
        return self.correlation


@dataclass(frozen=True)
class CandidateScoreEnsemble:
    """Combined check thresholds (contour_db.h:244-250)."""
    sim_constell: ScoreConstellSim = field(default_factory=ScoreConstellSim)
    sim_pair: ScorePairwiseSim = field(default_factory=ScorePairwiseSim)
    sim_post: ScorePostProc = field(default_factory=ScorePostProc)


DEFAULT_THRES_LB = CandidateScoreEnsemble(
    sim_constell=ScoreConstellSim(3, 3, 3),
    sim_pair=ScorePairwiseSim(3, 4),
    sim_post=ScorePostProc(0.3, 0.03, -5.01),
)  # batch_bin_test_config.yaml:70-78

DEFAULT_THRES_UB = CandidateScoreEnsemble(
    sim_constell=ScoreConstellSim(6, 6, 6),
    sim_pair=ScorePairwiseSim(6, 6),
    sim_post=ScorePostProc(0.75, 0.15, -5.0),
)  # batch_bin_test_config.yaml:79-87


@dataclass(frozen=True)
class ContourDBConfig:
    """Retrieval database knobs (contour_db.h:658-669)."""
    nnk: int = 50
    max_fine_opt: int = 10
    q_levels: Tuple[int, ...] = (1, 2, 3)
    cont_sim: ContourSimThresConfig = field(default_factory=ContourSimThresConfig)
    tb: TreeBucketConfig = field(default_factory=TreeBucketConfig)
    # device capacity knobs
    max_check_cands: int = 256    # candidate hints compacted into the batched
                                  # check cascade (KITTI averages ~18 hits/scan;
                                  # dense self-similar scenes spike into the
                                  # hundreds; overflow keeps the nearest-by-key-
                                  # distance hits and is counted in
                                  # ContourDB.counters). In a cap sweep at
                                  # ~35x-KITTI density recall saturated at 256:
                                  # caps 512 and 1024 missed the identical scans
                                  # (the residual misses are world geometry,
                                  # not cap truncation)
    max_pass_hints: int = 128     # cascade survivors fed to the on-device proposal merge
    max_cand_poses: int = 64      # candidate pose rows in the on-device
                                  # CandidateManager (the reference is unbounded;
                                  # overflow_cand counts drops — 64 keeps even
                                  # 14-lap self-similar loops mostly unclipped)
    dynamic_thres: bool = False   # DYNAMIC_THRES compile flag (CMakeLists.txt:19, contour_db.h:439-458)
    topk_strategy: str = "cover2"  # exact city-scale min-k reduction:
                                  # "cover2" (fused tile-min + key-column
                                  # re-gather, never materializes the
                                  # distance matrix — db._search_cover2),
                                  # "cover" (tile-min cover over the
                                  # materialized matrix) or "block"
                                  # (two-stage per-4096-block min-k). All
                                  # element-exact vs lax.top_k incl. tie
                                  # order. cover2 is paired with keys_bf16
    cascade_chunk: int = 128      # check-cascade chunk width W: the cascade
                                  # compiles ONCE at width W and runs over
                                  # ceil(n_valid/W) chunks (result-identical
                                  # — per-hint independent ops), so cost
                                  # tracks the live hint count instead of
                                  # the flat max_check_cands pad; KITTI-like
                                  # streams average ~18 hits/scan
                                  # (db._cascade_chunked). 0 = unchunked.
    check1_prefilter: bool = True  # run check 1 (anchor checkSim — a few
                                  # scalar gathers + elementwise math per
                                  # hint) over ALL selected hints first and
                                  # feed only its survivors, compacted in
                                  # hint order, to the chunked cascade:
                                  # checks 2/3 cost ~100x check 1 per hint
                                  # and pass2/3 require pass1, so skipped
                                  # rows contribute nothing downstream —
                                  # records are bit-identical (pinned by
                                  # tests/test_fused_query.py), the chunk
                                  # count drops from ceil(n_valid/W) to
                                  # ceil(aft1/W). Only active when the
                                  # cascade actually runs chunked.
    desc_batch: int = 1           # chain lowering: descriptor builds inside
                                  # step_chain/_dyn are vmapped in sub-batches
                                  # of this many scans (db._build_descs_chunked);
                                  # 1 = per-scan builds inside the sequential
                                  # loop (no chunk machinery). A lowering knob:
                                  # re-decide it whenever the descriptor
                                  # lowering changes.
    p_pot: Optional[int] = 128    # angular-window pair capacity per hint in
                                  # the check-2/3 cascade (None = ops/
                                  # cascade.P_POT, 512): the ascending-angle
                                  # sort keeps the first p_pot bit-adjacent
                                  # pairs; truncation beyond it is counted
                                  # per check-1 survivor in ContourDB.
                                  # counters["overflow_pot"]. The window +
                                  # member stages scale ~O(p_pot^2). At the
                                  # densest (35x-KITTI) synthetic load the
                                  # true pool sizes were p50=4 / p99=21 /
                                  # max=45 over 5903 check-1 survivors — 2.8x
                                  # headroom; overflow_pot discloses if a
                                  # denser map ever clips (raise to None/512
                                  # then).

    def __post_init__(self):
        # check-3 stats tables cover the DIST_BIN_LAYERS levels only; an
        # anchor level outside them would silently gather a neighbor's stats
        # (ops/cascade.gather_tab maps level -> row level-1)
        bad = [q for q in self.q_levels if q not in DIST_BIN_LAYERS]
        if bad:
            raise ValueError(f"q_levels {bad} outside DIST_BIN_LAYERS "
                             f"{DIST_BIN_LAYERS} are not supported")


@dataclass(frozen=True)
class PipelineConfig:
    """Everything the end-to-end loop-closure pipeline needs."""
    cm: ContourManagerConfig = field(default_factory=ContourManagerConfig)
    db: ContourDBConfig = field(default_factory=ContourDBConfig)
    gmm: GMMOptConfig = field(default_factory=GMMOptConfig)
    thres_lb: CandidateScoreEnsemble = DEFAULT_THRES_LB
    thres_ub: CandidateScoreEnsemble = DEFAULT_THRES_UB
    correlation_thres: float = 0.64928  # batch_bin_test_config.yaml:66


def mulran_pipeline_config() -> PipelineConfig:
    """Reference MulRan operating point (batch_bin_test_config.yaml:17,31)."""
    return PipelineConfig(
        cm=dataclasses.replace(ContourManagerConfig(), lv_grads=(1.0, 2.5, 4.0, 5.5, 7.0, 8.5)),
        db=dataclasses.replace(
            ContourDBConfig(), cont_sim=dataclasses.replace(ContourSimThresConfig(), ta_h_bar=0.75)
        ),
    )


def load_pipeline_config_yaml(path: str) -> Tuple[PipelineConfig, dict]:
    """Load a reference-format YAML config (batch_bin_test.cpp:38-100).

    Uses a tiny hand-rolled parser for the subset of YAML the reference uses
    (OpenCV FileStorage style: scalar keys, one nesting level, inline lists),
    so no YAML dependency is needed.  Returns the PipelineConfig plus a dict of
    the IO paths (fpath_sens_gt_pose / fpath_lidar_bins / fpath_outcome_sav).
    """
    raw: dict = {}
    stack: List[Tuple[int, dict]] = [(-1, raw)]
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].rstrip()
            if not line.strip() or line.strip().startswith(("%", "---")):
                continue
            indent = len(line) - len(line.lstrip())
            key, _, val = line.strip().partition(":")
            val = val.strip()
            while stack and stack[-1][0] >= indent:
                stack.pop()
            parent = stack[-1][1] if stack else raw
            if not val:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                if val.startswith("["):
                    parent[key] = [float(x) for x in val.strip("[]").split(",") if x.strip()]
                else:
                    try:
                        parent[key] = float(val) if ("." in val or "e" in val) else int(val)
                    except ValueError:
                        parent[key] = val.strip('"')

    def g(d, k, default):
        return d.get(k, default)

    cmr = raw.get("ContourManagerConfig", {})
    cm = ContourManagerConfig(
        lv_grads=tuple(g(cmr, "lv_grads_", (1.5, 2, 2.5, 3, 3.5, 4))),
        n_row=int(g(cmr, "n_row_", 150)),
        n_col=int(g(cmr, "n_col_", 150)),
        lidar_height=float(g(cmr, "lidar_height_", 2.0)),
        blind_sq=float(g(cmr, "blind_sq_", 9.0)),
        min_cont_key_cnt=int(g(cmr, "min_cont_key_cnt_", 9)),
        min_cont_cell_cnt=int(g(cmr, "min_cont_cell_cnt_", 3)),
        piv_firsts=int(g(cmr, "piv_firsts_", 6)),
        dist_firsts=int(g(cmr, "dist_firsts_", 10)),
        roi_radius=float(g(cmr, "roi_radius_", 10.0)),
    )
    dbr = raw.get("ContourDBConfig", {})
    simr = dbr.get("ContourSimThresConfig", {})
    tbr = dbr.get("TreeBucketConfig", {})
    db = ContourDBConfig(
        nnk=int(g(dbr, "nnk_", 50)),
        max_fine_opt=int(g(dbr, "max_fine_opt_", 10)),
        q_levels=tuple(int(x) for x in g(dbr, "q_levels_", (1, 2, 3))),
        cont_sim=ContourSimThresConfig(
            ta_cell_cnt=float(g(simr, "ta_cell_cnt", 6.0)),
            tp_cell_cnt=float(g(simr, "tp_cell_cnt", 0.2)),
            tp_eigval=float(g(simr, "tp_eigval", 0.2)),
            ta_h_bar=float(g(simr, "ta_h_bar", 0.3)),
            ta_rcom=float(g(simr, "ta_rcom", 0.4)),
            tp_rcom=float(g(simr, "tp_rcom", 0.25)),
        ),
        tb=TreeBucketConfig(
            max_elapse=float(g(tbr, "max_elapse_", 25.0)),
            min_elapse=float(g(tbr, "min_elapse_", 15.0)),
        ),
    )

    def ens(d) -> CandidateScoreEnsemble:
        return CandidateScoreEnsemble(
            sim_constell=ScoreConstellSim(
                int(d.get("i_ovlp_sum", 3)), int(d.get("i_ovlp_max_one", 3)), int(d.get("i_in_ang_rng", 3))
            ),
            sim_pair=ScorePairwiseSim(int(d.get("i_indiv_sim", 3)), int(d.get("i_orie_sim", 4))),
            sim_post=ScorePostProc(
                float(d.get("correlation", 0.3)),
                float(d.get("area_perc", 0.03)),
                float(d.get("neg_est_dist", -5.01)),
            ),
        )

    cfg = PipelineConfig(
        cm=cm,
        db=db,
        thres_lb=ens(raw.get("thres_lb_", {})),
        thres_ub=ens(raw.get("thres_ub_", {})),
        correlation_thres=float(g(raw, "correlation_thres", 0.64928)),
    )
    io_paths = {
        k: raw.get(k) for k in ("fpath_sens_gt_pose", "fpath_lidar_bins", "fpath_outcome_sav") if k in raw
    }
    return cfg, io_paths
