"""Jacobi-preconditioned restarted GMRES for a linear operator.

Port of biem_helmholtz_sphere_tpu/ops/cplx.py::gmres_solve_op/_gmres_cgs2:
Arnoldi with CGS2 orthogonalization, complex Givens rotations kept as
their accumulated product Q, and back-substitution, batched over the
leading axis of b (independent systems that iterate together).  The step
loop is a Python loop that stops the moment every system's
rotation-carried residual estimate is under tolerance.

A non-finite residual raises FloatingPointError: `resid > target` is
False for NaN, so a NaN solve would otherwise look converged after one
step.
"""

import os

import torch


def _inv_or_zero(a, tiny):
    return torch.where(a > tiny, 1.0 / torch.clamp(a, min=tiny), torch.zeros_like(a))


def _active(resid, target):
    """True while any system is above target; raise on a non-finite residual."""
    bad, active = torch.stack(
        [~torch.isfinite(resid).all(), (resid > target).any()]
    ).tolist()
    if bad:
        raise FloatingPointError(
            "GMRES residual is not finite: the operator or right-hand side "
            "produced NaN/inf"
        )
    return active


def gmres_solve_op(mv, diag, b, tol=None, restart=None, maxiter=20, x0=None):
    """Solve A x = b by left-Jacobi-preconditioned GMRES(restart).

    mv: callable [K, N] -> [K, N] (complex); diag: A's diagonal [K, N];
    b: [K, N]; x0: optional warm start [K, N].  tol is relative to
    ||M^-1 b|| (default 3e-5 in float32, 1e-11 in float64; with tol None,
    the environment's BHS_GMRES_TOL_F32 / BHS_GMRES_TOL overrides the
    default for that precision, as in the JAX package, for artifact rows
    that need more converged digits); restart
    defaults to 48 (float32) / 192 (float64) Krylov steps; maxiter counts
    restart cycles.  Returns (x, relres [K], iters [K]): the final
    rotation-carried preconditioned relative residual estimate and the
    Krylov steps each system needed.
    """
    f32 = b.dtype == torch.complex64
    if tol is None:
        tol = 3e-5 if f32 else 1e-11
        env = os.environ.get("BHS_GMRES_TOL_F32" if f32 else "BHS_GMRES_TOL")
        if env:
            tol = float(env)
    m = restart if restart is not None else (48 if f32 else 192)
    m = max(1, min(m, b.shape[-1]))
    return _gmres_cgs2(mv, diag, b, tol, m, maxiter, x0)


def _gmres_cgs2(mv, diag, b, tol, m, maxiter, x0):
    rdt = b.real.dtype
    n_sys, n = b.shape
    tiny = float(torch.finfo(rdt).tiny) ** 0.5
    kw = dict(dtype=b.dtype, device=b.device)

    def pre_mv(x):
        return mv(x) / diag

    b_pre = b / diag
    bnorm = torch.linalg.vector_norm(b_pre, dim=-1)
    target = tol * bnorm
    if not bool(torch.isfinite(bnorm).all()):
        raise FloatingPointError("GMRES right-hand side is not finite")

    def cycle(x):
        r = b_pre - pre_mv(x)
        beta = torch.linalg.vector_norm(r, dim=-1)
        V = torch.zeros((n_sys, m + 1, n), **kw)
        V[:, 0] = r * _inv_or_zero(beta, tiny)[:, None]
        R = torch.zeros((n_sys, m, m), **kw)  # R[k, col, row]
        g = torch.zeros((n_sys, m + 1), **kw)
        g[:, 0] = beta
        Q = torch.eye(m + 1, **kw).expand(n_sys, m + 1, m + 1).clone()
        resid = beta
        steps = torch.zeros(n_sys, dtype=torch.int32, device=b.device)
        j_f = 0
        for j in range(m):
            if not _active(resid, target):
                break
            steps += (resid > target).to(torch.int32)
            w = pre_mv(V[:, j])
            vj = V[:, : j + 1]
            h1 = (vj.conj() @ w[:, :, None])[..., 0]  # [K, j+1]
            w = w - (h1[:, None, :] @ vj)[:, 0]
            h2 = (vj.conj() @ w[:, :, None])[..., 0]  # CGS2: reorthogonalize
            w = w - (h2[:, None, :] @ vj)[:, 0]
            h = h1 + h2
            hn = torch.linalg.vector_norm(w, dim=-1)
            V[:, j + 1] = w * _inv_or_zero(hn, tiny)[:, None]
            # rotate the new column by the accumulated rotations
            hr = (Q[:, :, : j + 1] @ h[:, :, None])[..., 0]  # [K, m+1]
            a = hr[:, j]
            rr = torch.sqrt(a.abs() ** 2 + hn * hn)
            inv_r = _inv_or_zero(rr, tiny)
            uj = torch.where(rr > tiny, a.conj() * inv_r, torch.ones_like(a))
            vj_ = (hn * inv_r).to(b.dtype)
            qj, qj1 = Q[:, j].clone(), Q[:, j + 1].clone()
            Q[:, j] = uj[:, None] * qj + vj_[:, None] * qj1
            Q[:, j + 1] = qj1 * uj.conj()[:, None] - qj * vj_[:, None]
            hr[:, j] = rr
            R[:, j] = hr[:, :m]
            gj = g[:, j].clone()
            g[:, j] = uj * gj
            g[:, j + 1] = -gj * vj_
            resid = (gj * vj_).abs()
            j_f = j + 1
        _active(resid, target)  # raises on a non-finite final estimate
        # back-substitution on the rotated (upper-triangular) system
        y = torch.zeros((n_sys, m), **kw)
        for col in reversed(range(j_f)):
            s = (R[:, col + 1 : j_f, col] * y[:, col + 1 : j_f]).sum(-1)
            rll = R[:, col, col]
            scale = _inv_or_zero(rll.abs(), tiny)
            y[:, col] = (g[:, col] - s) * (rll.conj() * (scale * scale))
        corr = (y[:, None, :j_f] @ V[:, :j_f])[:, 0]
        return x + corr, resid, steps

    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).expand_as(b).clone()
    nsteps = torch.zeros(n_sys, dtype=torch.int32, device=b.device)
    for _ in range(maxiter):
        x, resid, steps = cycle(x)
        nsteps += steps
        if not bool((resid > target).any()):
            break
    return x, resid * _inv_or_zero(bnorm, tiny), nsteps
