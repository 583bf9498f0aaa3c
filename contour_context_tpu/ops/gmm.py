"""Batched GMM L2 correlation + fixed-iteration Levenberg-Marquardt refinement.

Replaces the reference's per-candidate Ceres solve (correlation.h:157-238,
AutoDiffFirstOrderFunction + LBFGS, <=10 iters) with a batched 3-parameter
(x, y, theta) LM optimizer using jax.grad/jax.hessian — thousands of
query-candidate pairs per dispatch.

GMM data layout per scan (from ScanDesc, levels = GMMOptConfig.levels):
  mus  (G, K, 2), covs (G, K, 2, 2), ws (G, K) (0 where outside the 95%-area
  prefix), majax (G, K) = sqrt(lambda_max). Selected pairs are a (G, K, K)
  mask fixed at init (correlation.h:85-96).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from contour_context_tpu.config import GMMOptConfig


class GmmScan(NamedTuple):
    mus: jnp.ndarray    # (G, K, 2)
    covs: jnp.ndarray   # (G, K, 2, 2)
    ws: jnp.ndarray     # (G, K)
    majax: jnp.ndarray  # (G, K)
    auto_corr: jnp.ndarray  # ()


def l2_pairwise(mus1, covs1, ws1, mus2, covs2, ws2, scale: float):
    """Pairwise GMM L2 kernel values (correlation.h:125-152 inner term):
    w1_j w2_k / sqrt(det S) exp(-1/2 mu^T S^-1 mu), S = scale*(C1_j + C2_k).

    Shapes (..., K, 2) / (..., K, 2, 2) / (..., K) -> (..., K, K). The ONE
    implementation shared by the cost functor and the descriptor's
    auto-correlation (their numeric identity normalizes corr scores)."""
    S = scale * (covs1[..., :, None, :, :] + covs2[..., None, :, :, :])
    det = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    dmu = mus1[..., :, None, :] - mus2[..., None, :, :]
    q = (S[..., 1, 1] * dmu[..., 0] ** 2
         - 2 * S[..., 0, 1] * dmu[..., 0] * dmu[..., 1]
         + S[..., 0, 0] * dmu[..., 1] ** 2) / jnp.maximum(det, 1e-12)
    return (ws1[..., :, None] * ws2[..., None, :]
            * jax.lax.rsqrt(jnp.maximum(det, 1e-12)) * jnp.exp(-0.5 * q))


def gmm_from_desc(desc, gmm_cfg: GMMOptConfig) -> GmmScan:
    lev = jnp.array(gmm_cfg.levels, jnp.int32)
    K = gmm_cfg.max_gmm_ellipses   # contours are area-sorted; the gmm_mask's
    # 95%-area prefix virtually never exceeds this (correlation.h:63-71)
    ws = jnp.where(desc.gmm_mask[lev][:, :K],
                   desc.cnt[lev][:, :K].astype(jnp.float32), 0.0)
    return GmmScan(
        mus=desc.mean[lev][:, :K],
        covs=desc.manual_cov[lev][:, :K],
        ws=ws,
        majax=jnp.sqrt(desc.eig_vals[lev][:, :K][..., 1]),
        auto_corr=desc.auto_corr,
    )


def select_pairs(src: GmmScan, tgt: GmmScan, T_init: jnp.ndarray) -> jnp.ndarray:
    """(G, K, K) bool mask of close pairs under T_init (correlation.h:85-96)."""
    x, y, th = T_init[0], T_init[1], T_init[2]
    c, s = jnp.cos(th), jnp.sin(th)
    mu_s = src.mus
    tx = c * mu_s[..., 0] - s * mu_s[..., 1] + x
    ty = s * mu_s[..., 0] + c * mu_s[..., 1] + y
    dx = tx[:, :, None] - tgt.mus[..., 0][:, None, :]
    dy = ty[:, :, None] - tgt.mus[..., 1][:, None, :]
    d = jnp.sqrt(dx * dx + dy * dy)
    thr = 3.0 * (src.majax[:, :, None] + tgt.majax[:, None, :])
    return (d < thr) & (src.ws[:, :, None] > 0) & (tgt.ws[:, None, :] > 0)


def gmm_cost(params: jnp.ndarray, src: GmmScan, tgt: GmmScan,
             sel: jnp.ndarray, scale: float) -> jnp.ndarray:
    """The Ceres cost functor (correlation.h:125-152): negative L2 product."""
    x, y, th = params[0], params[1], params[2]
    c, s = jnp.cos(th), jnp.sin(th)
    R = jnp.array([[c, -s], [s, c]])
    # rotated src covs: R C R^T, (G, K, 2, 2)
    RC = jnp.einsum("ab,gkbc->gkac", R, src.covs, precision=jax.lax.Precision.HIGHEST)
    RCRt = jnp.einsum("gkac,bc->gkab", RC, R, precision=jax.lax.Precision.HIGHEST)
    mu_s = src.mus
    tmus = jnp.stack([c * mu_s[..., 0] - s * mu_s[..., 1] + x,
                      s * mu_s[..., 0] + c * mu_s[..., 1] + y], axis=-1)
    val = l2_pairwise(tmus, RCRt, src.ws, tgt.mus, tgt.covs, tgt.ws, scale)
    return -jnp.sum(jnp.where(sel, val, 0.0))


def _corr_norm(src: GmmScan, tgt: GmmScan):
    return jnp.sqrt(jnp.maximum(src.auto_corr * tgt.auto_corr, 1e-12))


def gmm_value_grad_hess(params: jnp.ndarray, src: GmmScan, tgt: GmmScan,
                        sel: jnp.ndarray, scale: float):
    """Analytic (cost, gradient, Hessian) of gmm_cost w.r.t. (x, y, theta).

    Replaces forward-over-reverse AD inside the LM refinement loop: the AD
    pipeline emitted hundreds of small sequential kernels per iteration;
    the closed form is one fused elementwise pass over the (G, K, K) pair
    grid plus ten scalar reductions. Exactness is pinned against
    jax.grad/jax.hessian of gmm_cost in test_cascade.py.

    Derivation (per selected pair; u = R mu_j, m = u + t - mu_k,
    S = scale*(R C_j R^T + C_k), E = R C_j R^T, v = w det(S)^{-1/2}
    exp(-q/2), q = m^T S^{-1} m, L = log v):
      dE/dtheta   = [[-2 E01, E00 - E11], [., 2 E01]]
      d2E/dtheta2 = [[-2(E00-E11), -4 E01], [., 2(E00-E11)]]
      dL/dp = -1/2 tr(S^-1 dS) - 1/2 dq,  dq = 2 dm.alpha - alpha.dS.alpha
      with alpha = S^-1 m; second derivatives via alpha_theta =
      S^-1 m_theta - S^-1 S_theta alpha and m_thetatheta = -u.
    Hess = -sum v (L_p L_q + L_pq); grad = -sum v L_p.
    """
    x, y, th = params[0], params[1], params[2]
    c, s = jnp.cos(th), jnp.sin(th)
    g2 = scale

    muj = src.mus                                     # (G, K, 2)
    a = src.covs[..., 0, 0]
    b = src.covs[..., 0, 1]
    d = src.covs[..., 1, 1]
    u0 = c * muj[..., 0] - s * muj[..., 1]
    u1 = s * muj[..., 0] + c * muj[..., 1]
    E00 = c * c * a - 2 * c * s * b + s * s * d
    E01 = c * s * (a - d) + (c * c - s * s) * b
    E11 = s * s * a + 2 * c * s * b + c * c * d

    def J(z):                                         # src j -> pair grid
        return z[..., :, None]

    def Kx(z):                                        # tgt k -> pair grid
        return z[..., None, :]

    ck00 = tgt.covs[..., 0, 0]
    ck01 = tgt.covs[..., 0, 1]
    ck11 = tgt.covs[..., 1, 1]
    S00 = g2 * (J(E00) + Kx(ck00))
    S01 = g2 * (J(E01) + Kx(ck01))
    S11 = g2 * (J(E11) + Kx(ck11))
    S00t = -2 * g2 * J(E01)                           # dS/dtheta
    S01t = g2 * J(E00 - E11)
    S11t = 2 * g2 * J(E01)
    S00tt = -2 * g2 * J(E00 - E11)                    # d2S/dtheta2
    S01tt = -4 * g2 * J(E01)
    S11tt = 2 * g2 * J(E00 - E11)

    m0 = J(u0) + x - Kx(tgt.mus[..., 0])
    m1 = J(u1) + y - Kx(tgt.mus[..., 1])
    mt0 = J(-u1)                                      # dm/dtheta = R' mu_j
    mt1 = J(u0)
    mtt0 = J(-u0)                                     # d2m/dtheta2 = -u
    mtt1 = J(-u1)

    det = jnp.maximum(S00 * S11 - S01 * S01, 1e-12)
    inv_det = 1.0 / det
    I00 = S11 * inv_det
    I01 = -S01 * inv_det
    I11 = S00 * inv_det
    al0 = I00 * m0 + I01 * m1                         # alpha = S^-1 m
    al1 = I01 * m0 + I11 * m1
    q = m0 * al0 + m1 * al1

    w = jnp.where(sel, J(src.ws) * Kx(tgt.ws), 0.0)
    v = w * jax.lax.rsqrt(det) * jnp.exp(-0.5 * q)

    # first derivatives of L
    Lx = -al0
    Ly = -al1
    Sta0 = S00t * al0 + S01t * al1                    # S_theta alpha
    Sta1 = S01t * al0 + S11t * al1
    trt = I00 * S00t + 2 * I01 * S01t + I11 * S11t
    qt = 2 * (mt0 * al0 + mt1 * al1) - (al0 * Sta0 + al1 * Sta1)
    Lt = -0.5 * trt - 0.5 * qt

    # second derivatives of L
    Lxx = -I00
    Lxy = -I01
    Lyy = -I11
    bt0 = I00 * mt0 + I01 * mt1                       # S^-1 m_theta
    bt1 = I01 * mt0 + I11 * mt1
    dl0 = I00 * Sta0 + I01 * Sta1                     # S^-1 S_theta alpha
    dl1 = I01 * Sta0 + I11 * Sta1
    at0 = bt0 - dl0                                   # alpha_theta
    at1 = bt1 - dl1
    Lxt = -at0
    Lyt = -at1
    Mt00 = I00 * S00t + I01 * S01t                    # S^-1 S_theta
    Mt01 = I00 * S01t + I01 * S11t
    Mt10 = I01 * S00t + I11 * S01t
    Mt11 = I01 * S01t + I11 * S11t
    trtt = -(Mt00 * Mt00 + 2 * Mt01 * Mt10 + Mt11 * Mt11) \
        + (I00 * S00tt + 2 * I01 * S01tt + I11 * S11tt)
    qtt = (2 * (mtt0 * al0 + mtt1 * al1)
           + 2 * (mt0 * at0 + mt1 * at1)
           - 2 * (at0 * Sta0 + at1 * Sta1)
           - (al0 * al0 * S00tt + 2 * al0 * al1 * S01tt
              + al1 * al1 * S11tt))
    Ltt = -0.5 * trtt - 0.5 * qtt

    red = lambda z: jnp.sum(v * z)
    f = -jnp.sum(v)
    grad = -jnp.stack([red(Lx), red(Ly), red(Lt)])
    hxx = red(Lx * Lx + Lxx)
    hxy = red(Lx * Ly + Lxy)
    hxt = red(Lx * Lt + Lxt)
    hyy = red(Ly * Ly + Lyy)
    hyt = red(Ly * Lt + Lyt)
    htt = red(Lt * Lt + Ltt)
    hess = -jnp.array([[hxx, hxy, hxt],
                       [hxy, hyy, hyt],
                       [hxt, hyt, htt]])
    return f, grad, hess


@functools.partial(jax.jit, static_argnames=("scale",))
def init_correlation(src_batch: GmmScan, tgt: GmmScan, T_init: jnp.ndarray,
                     scale: float = 2.0):
    """Batched initProblem evaluation (correlation.h:175-202).

    src_batch: GmmScan with leading batch dim C; tgt: single scan;
    T_init: (C, 3). Returns (corr (C,), sel (C, G, K, K)).
    """
    def one(src, T):
        sel = select_pairs(src, tgt, T)
        cost = gmm_cost(T, src, tgt, sel, scale)
        return -cost / _corr_norm(src, tgt), sel

    return jax.vmap(one)(src_batch, T_init)


@functools.partial(jax.jit, static_argnames=("scale", "iters"))
def optimize_correlation(src_batch: GmmScan, tgt: GmmScan, T_init: jnp.ndarray,
                         sel: jnp.ndarray, scale: float = 2.0, iters: int = 10):
    """Batched LM refinement of (x, y, theta), `iters` fixed iterations.

    Mirrors calcCorrelation (correlation.h:206-238) with LM in place of the
    Ceres LBFGS line-search (same smooth objective, same iteration budget).
    Returns (corr (C,), T_opt (C, 3)).
    """
    def _solve3(A, b):
        """Closed-form 3x3 solve (adjugate/Cramer). jnp.linalg.solve lowers
        a tiny LU factorization to a library call or a serialized loop; the
        LM system is 3x3 and damped PD, so the explicit cofactor form is one
        fused elementwise kernel instead. The product asks for HIGHEST
        precision so no backend runs it at reduced float32 precision."""
        c00 = A[1, 1] * A[2, 2] - A[1, 2] * A[2, 1]
        c01 = A[1, 2] * A[2, 0] - A[1, 0] * A[2, 2]
        c02 = A[1, 0] * A[2, 1] - A[1, 1] * A[2, 0]
        c10 = A[0, 2] * A[2, 1] - A[0, 1] * A[2, 2]
        c11 = A[0, 0] * A[2, 2] - A[0, 2] * A[2, 0]
        c12 = A[0, 1] * A[2, 0] - A[0, 0] * A[2, 1]
        c20 = A[0, 1] * A[1, 2] - A[0, 2] * A[1, 1]
        c21 = A[0, 2] * A[1, 0] - A[0, 0] * A[1, 2]
        c22 = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
        det = A[0, 0] * c00 + A[0, 1] * c01 + A[0, 2] * c02
        adj = jnp.array([[c00, c10, c20], [c01, c11, c21], [c02, c12, c22]])
        return (jnp.matmul(adj, b, precision=jax.lax.Precision.HIGHEST)
                / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30))

    def one(src, T0, sel_i):
        def vgh(p):
            return gmm_value_grad_hess(p, src, tgt, sel_i, scale)

        def step(carry, _):
            p, f, lam = carry
            # analytic value+grad+Hessian in one fused elementwise pass
            # (gmm_value_grad_hess) — forward-over-reverse AD here emitted
            # hundreds of small sequential kernels per LM iteration
            _f0, g, Hm = vgh(p)
            A = Hm + lam * jnp.eye(3)
            dp = _solve3(A + 1e-9 * jnp.eye(3), -g)
            p_new = p + dp
            # value-only probe: XLA dead-code-eliminates the unused grad/
            # Hessian outputs, and sharing vgh keeps the floats consistent
            f_new, _, _ = vgh(p_new)
            ok = (f_new < f) & jnp.all(jnp.isfinite(p_new))
            p = jnp.where(ok, p_new, p)
            f = jnp.where(ok, f_new, f)
            lam = jnp.where(ok, lam * 0.33, lam * 10.0)
            return (p, f, lam), None

        f0, _, _ = vgh(T0)
        (p, f, _), _ = jax.lax.scan(step, (T0, f0, jnp.float32(1e-3)),
                                    None, length=iters)
        return -f / _corr_norm(src, tgt), p

    return jax.vmap(one)(src_batch, T_init, sel)
