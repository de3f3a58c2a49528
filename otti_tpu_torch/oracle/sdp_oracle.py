# copied from otti_tpu/oracle/sdp_oracle.py
"""SDP witness oracle: primal-dual interior-point solver (HKM direction).

Replaces the reference's CSDP 6.2.0 binary `__GADGET_sdp` oracle — whose
blob is stripped from the snapshot (SURVEY.md §0.1) — with a self-contained
numpy implementation adequate for the SDPLIB instances (n <= ~50).  As
with all Otti oracles, the solver runs outside the proof; the R1CS checks
the certificate (A_i.X = b_i, Cholesky-witnessed PSD of X and the dual
slack S, complementary slackness <S, X> ~ 0; SURVEY.md §3.2).

Standard primal-dual central-path Newton steps with the HKM direction:
    <A_i, DX> = rp_i,   sum_i Dy_i A_i + DS = Rd,   DX S + X DS = sigma*mu*I - X S
Schur complement  M_ij = <A_i, X A_j S^{-1}>  solved densely per iteration.
"""

from __future__ import annotations

import numpy as np

from ..io.sdpa import SDPProblem


def _is_pd(M: np.ndarray) -> bool:
    try:
        np.linalg.cholesky(M)
        return True
    except np.linalg.LinAlgError:
        return False


def _max_step(M: np.ndarray, dM: np.ndarray, tau: float = 0.98) -> float:
    """Largest alpha in (0, 1] with M + alpha*dM positive definite."""
    alpha = 1.0
    for _ in range(40):
        if _is_pd(M + alpha * dM):
            return alpha
        alpha *= 0.7
    return 0.0


def _facial_reduction(prob: SDPProblem):
    """Coordinates j with C_jj = 0 and A_i,jj = 0 for all i force S_jj = 0,
    hence (PSD) the whole row/col of the dual slack to zero — the central
    path does not exist there (dual Slater fails; SDPLIB truss family).
    Delete them, solve the reduced SDP, and lift X, S back with zeros:
    primal feasibility, PSD-ness, and the zero gap are all preserved.
    Returns (reduced_prob, keep_indices) or None if nothing reduces."""
    n = prob.n
    tol = 1e-12
    forced = [
        j
        for j in range(n)
        if abs(prob.C[j, j]) < tol
        and all(abs(Ai[j, j]) < tol for Ai in prob.A)
    ]
    if not forced:
        return None
    keep = [j for j in range(n) if j not in forced]
    if not keep:
        return None
    idx = np.ix_(keep, keep)
    red = SDPProblem(
        name=prob.name + "(reduced)",
        n=len(keep),
        m=prob.m,
        C=prob.C[idx],
        A=[Ai[idx] for Ai in prob.A],
        b=prob.b,
    )
    return red, keep


def solve(prob: SDPProblem, tol: float = 1e-7, max_iter: int = 300):
    """-> (X, y, S) primal/dual optimal with <X,S> ~= 0.

    Mehrotra predictor-corrector on the HKM direction: the affine step
    sets sigma = (mu_aff/mu)^3 and the corrector folds in the
    -dX_aff dS_aff S^{-1} second-order term.  Stopping is
    certificate-aware: the Otti statement only needs epsilon=1e-2-scaled
    feasibility/complementarity (SURVEY.md §3.2), so a stall slightly
    above ``tol`` still yields a valid witness.
    """
    red = _facial_reduction(prob)
    if red is not None:
        red_prob, keep = red
        Xr, y, Sr = solve(red_prob, tol=tol, max_iter=max_iter)
        X = np.zeros((prob.n, prob.n))
        S = np.zeros((prob.n, prob.n))
        X[np.ix_(keep, keep)] = Xr
        S[np.ix_(keep, keep)] = Sr
        return X, y, S

    n, m = prob.n, prob.m
    A, b, C = prob.A, prob.b, prob.C
    scale = max(1.0, float(np.abs(C).max()), float(np.abs(b).max() if m else 1.0))
    X = np.eye(n) * scale
    S = np.eye(n) * scale
    y = np.zeros(m)
    best = None

    def residuals(X, y, S):
        rp = b - np.asarray([(Ai * X).sum() for Ai in A])
        Rd = C - S - sum(yi * Ai for yi, Ai in zip(y, A))
        return rp, Rd

    def rel_err(X, y, S):
        rp, Rd = residuals(X, y, S)
        gap = abs((X * S).sum())
        return max(
            np.abs(rp).max() / (1 + (np.abs(b).max() if m else 1.0)),
            np.abs(Rd).max() / (1 + np.abs(C).max()),
            gap / (1 + abs((C * X).sum())),
        )

    for it in range(max_iter):
        rp, Rd = residuals(X, y, S)
        mu = (X * S).sum() / n
        err = rel_err(X, y, S)
        if best is None or err < best[0]:
            best = (err, X.copy(), y.copy(), S.copy())
        if err < tol:
            break
        Ssym = 0.5 * (S + S.T)
        try:
            Sinv = np.linalg.inv(Ssym)
        except np.linalg.LinAlgError:
            Sinv = np.linalg.pinv(Ssym + 1e-12 * np.trace(Ssym) / n * np.eye(n))
        XAS = [X @ Ai @ Sinv for Ai in A]
        M = np.empty((m, m))
        for i in range(m):
            for j in range(m):
                M[i, j] = (A[i] * XAS[j]).sum()
        M = 0.5 * (M + M.T) + 1e-13 * max(np.trace(M) / max(m, 1), 1.0) * np.eye(m)

        def solve_dir(sigma_mu, corr):
            XRdS = X @ Rd @ Sinv
            corrS = corr @ Sinv
            rhs = np.asarray(
                [
                    b[i]
                    - sigma_mu * (A[i] * Sinv).sum()
                    + (A[i] * XRdS).sum()
                    + (A[i] * corrS).sum()
                    for i in range(m)
                ]
            )
            try:
                dy = np.linalg.solve(M, rhs)
            except np.linalg.LinAlgError:
                dy = np.linalg.lstsq(M, rhs, rcond=None)[0]
            dS = Rd - sum(dyi * Ai for dyi, Ai in zip(dy, A))
            dX = sigma_mu * Sinv - X - X @ dS @ Sinv - corrS
            return 0.5 * (dX + dX.T), dy, dS

        # predictor (affine scaling)
        dXa, dya, dSa = solve_dir(0.0, np.zeros((n, n)))
        ap_a = _max_step(X, dXa)
        ad_a = _max_step(S, dSa)
        mu_aff = ((X + ap_a * dXa) * (S + ad_a * dSa)).sum() / n
        sigma = min(1.0, max(0.0, mu_aff / mu) ** 3) if mu > 0 else 0.1
        # corrector with the Mehrotra second-order term
        dX, dy, dS = solve_dir(sigma * mu, dXa @ dSa)
        ap = _max_step(X, dX)
        ad = _max_step(S, dS)
        if ap < 1e-10 and ad < 1e-10:
            break
        X = X + ap * dX
        S = S + ad * dS
        y = y + ad * dy

    err_now = rel_err(X, y, S)
    if best is not None and best[0] < err_now:
        err_now, X, y, S = best
    rp, Rd = residuals(X, y, S)
    gap = abs((X * S).sum())
    # certificate-aware acceptance: the in-circuit comparators use the
    # ABSOLUTE epsilon = 1e-2 (sdpcodegen.py:98), so accept any point whose
    # absolute residuals leave >=2x headroom under it; fall back to the
    # relative criterion for very large-scale instances.
    abs_ok = (
        gap < 5e-3
        and (np.abs(rp).max() if m else 0.0) < 5e-3
        and np.abs(Rd).max() < 5e-3
    )
    if not abs_ok and err_now > 1e-3:
        # robust fallbacks: dual log-det barrier, optionally on a
        # delta-perturbed C (C + delta*I restores a dual interior when
        # Slater fails; the certificate's absolute epsilon = 1e-2 dwarfs
        # the perturbation, so the witness still satisfies the circuit).
        last = None
        for delta in (0.0, 1e-6, 1e-5, 1e-4):
            try:
                pprob = prob
                if delta:
                    pprob = SDPProblem(
                        name=prob.name,
                        n=prob.n,
                        m=prob.m,
                        C=prob.C + delta * scale * np.eye(n),
                        A=prob.A,
                        b=prob.b,
                    )
                X2, y2, S2 = _dual_barrier_solve(pprob)
                # express the slack against the ORIGINAL C
                S2 = C - sum(yi * Ai for yi, Ai in zip(y2, A))
                rp2 = (
                    np.abs(b - np.asarray([(Ai * X2).sum() for Ai in A])).max()
                    if m
                    else 0.0
                )
                gap2 = abs((X2 * S2).sum())
                smin = float(np.linalg.eigvalsh(0.5 * (S2 + S2.T)).min())
                if gap2 < 5e-3 and rp2 < 5e-3 and smin > -5e-3:
                    return X2, y2, S2
                last = (gap2, rp2, smin)
            except RuntimeError as e:
                last = str(e)
        raise RuntimeError(
            f"SDP oracle did not converge on {prob.name}: "
            f"rel={err_now:.2e} gap={gap:.2e} rp={np.abs(rp).max():.2e} "
            f"rd={np.abs(Rd).max():.2e} (fallbacks: {last})"
        )
    return X, y, S


def _dual_barrier_solve(prob: SDPProblem, max_outer: int = 60):
    """Dual log-det barrier fallback (robust for small m).

    Minimize  -b.y - mu * logdet(S(y)),  S(y) = C - sum y_i A_i, by damped
    Newton in y (dim m), annealing mu; the primal recovers as X = mu *
    S^{-1}, which satisfies <A_i, X> = b_i at each barrier optimum and
    <S, X> = n*mu -> 0.  Handles central-path geometries where the
    primal-dual HKM iteration diverges (e.g. SDPLIB truss family).
    """
    n, m = prob.n, prob.m
    A, b, C = prob.A, prob.b, prob.C

    def S_of(y):
        return C - sum(yi * Ai for yi, Ai in zip(y, A))

    # ---- phase 1: find strictly dual-feasible y --------------------------
    # maximize lambda_min(S(y)) through a smoothed log-sum-exp surrogate
    # (plain subgradient stalls on eigenvalue kinks, e.g. truss family)
    from scipy.optimize import minimize as _scipy_min

    cscale = max(1.0, np.abs(C).max())
    y = np.zeros(m)
    for beta in (1.0, 4.0, 16.0, 64.0, 256.0):

        def f_smooth(yv, beta=beta):
            S = 0.5 * (S_of(yv) + S_of(yv).T)
            w, V = np.linalg.eigh(S / cscale)
            z = -beta * w
            zmax = z.max()
            ez = np.exp(z - zmax)
            f = (zmax + np.log(ez.sum())) / beta
            wts = ez / ez.sum()
            # d lambda_k / d y_i = -<A_i, v_k v_k^T> / cscale
            g = np.asarray(
                [
                    float((wts * np.einsum("ik,ij,jk->k", V, Ai, V)).sum())
                    / cscale
                    for Ai in A
                ]
            )
            return f, g

        res = _scipy_min(f_smooth, y, jac=True, method="BFGS",
                         options={"maxiter": 300, "gtol": 1e-12})
        y = res.x
        S = 0.5 * (S_of(y) + S_of(y).T)
        if np.linalg.eigvalsh(S).min() > 1e-6 * cscale:
            break
    S = 0.5 * (S_of(y) + S_of(y).T)
    if np.linalg.eigvalsh(S).min() <= 0:
        raise RuntimeError(f"SDP oracle: no strictly feasible dual point on {prob.name}")

    # ---- phase 2: barrier path following ---------------------------------
    S = S_of(y)
    mu = max(1.0, float(np.trace(S)) / n)
    scale = max(1.0, np.abs(b).max() if m else 1.0)
    target_mu = 1e-9 * scale
    for _ in range(max_outer):
        for _ in range(50):  # Newton steps at this mu
            S = 0.5 * (S_of(y) + S_of(y).T)
            Sinv = np.linalg.inv(S)
            g = np.asarray([-b[i] + mu * (Sinv * A[i]).sum() for i in range(m)])
            SA = [Sinv @ Ai for Ai in A]
            H = np.asarray(
                [[mu * (SA[i] * SA[j].T).sum() for j in range(m)] for i in range(m)]
            )
            H = 0.5 * (H + H.T) + 1e-14 * np.trace(H) / max(m, 1) * np.eye(m)
            try:
                dy = -np.linalg.solve(H, g)
            except np.linalg.LinAlgError:
                dy = -np.linalg.lstsq(H, g, rcond=None)[0]
            # backtrack to stay strictly feasible and decrease f
            t = 1.0
            f0 = -b @ y - mu * np.linalg.slogdet(S)[1]
            for _ in range(60):
                y_new = y + t * dy
                S_new = 0.5 * (S_of(y_new) + S_of(y_new).T)
                if _is_pd(S_new):
                    f1 = -b @ y_new - mu * np.linalg.slogdet(S_new)[1]
                    if f1 <= f0 + 1e-12 * abs(f0):
                        break
                t *= 0.5
            else:
                t = 0.0
            if t == 0.0 or np.linalg.norm(t * dy) < 1e-14 * (1 + np.linalg.norm(y)):
                break
            y = y + t * dy
            if np.linalg.norm(g) < 1e-10 * (1 + np.abs(b).max()):
                break
        if mu <= target_mu:
            break
        mu = max(target_mu, mu * 0.2)
    S = 0.5 * (S_of(y) + S_of(y).T)
    X = mu * np.linalg.inv(S)
    X = 0.5 * (X + X.T)
    return X, y, S


def cholesky_witness(M: np.ndarray) -> np.ndarray:
    """Lower-triangular L with L L^T ~= M (PSD witness, jittered)."""
    n = M.shape[0]
    for jitter in (0.0, 1e-12, 1e-10, 1e-8, 1e-6):
        try:
            return np.linalg.cholesky(M + jitter * np.eye(n))
        except np.linalg.LinAlgError:
            continue
    # eigen-clip fallback
    w, V = np.linalg.eigh(0.5 * (M + M.T))
    w = np.clip(w, 0.0, None)
    return np.linalg.cholesky(V @ np.diag(w) @ V.T + 1e-8 * np.eye(n))
