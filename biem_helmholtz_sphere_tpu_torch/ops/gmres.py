"""Jacobi-preconditioned restarted GMRES for a linear operator.

Port of biem_helmholtz_sphere_tpu/ops/cplx.py::gmres_solve_op/_gmres_cgs2:
Arnoldi with CGS2 orthogonalization, complex Givens rotations kept as
their accumulated product Q, and back-substitution, batched over the
leading axis of b (independent systems that iterate together).

The JAX package runs a whole solve as one device program (a scan of steps
under lax.cond, a while loop of restarts).  Here the host loops over the
steps, but never waits on each: a cycle's state and its flag word (any
system active, any residual non-finite, the steps that ran) stay on the
device (ops/gmres_step.py, K6 on the card), a step that finds no system
active leaves the state unchanged, and the host reads the word only every
`lag` steps, `lag` steps late, through a pinned buffer and a CUDA event.
So a cycle may launch up to 2 (lag - 1) matvecs past convergence whose
steps do nothing; the lag is fixed per call, so the results and the number
of matvecs do not depend on timing, and replicated solves (parallel/) call
`mv` equally often on every rank.

A non-finite residual raises FloatingPointError: `resid > target` is
False for NaN, so a NaN solve would otherwise look converged after one
step.
"""

import os

import torch

from .gmres_step import _inv_or_zero, arnoldi_state, arnoldi_step, backsolve

# Steps between the host's reads of the flag word on the card, each read
# `_LAG_CUDA` steps late (PERF.md section 5: the lags measured); CPU
# tensors read it before every step.
_LAG_CUDA = 2


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

    Counts (read by chip_smoke.py): `gmres_solve_op.host_reads` (reads of
    the flag word), `.steps_issued` (Arnoldi steps launched, each after a
    matvec) and `.steps_run` (those not masked).
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


gmres_solve_op.host_reads = 0
gmres_solve_op.steps_issued = 0
gmres_solve_op.steps_run = 0


class _FlagReader:
    """The host's view of the flag word: `post` queues a copy of the word
    (on the card into a pinned buffer, with an event after it), `read`
    waits for the newest copy and returns it as a list.  One buffer is
    enough: `_cycle` reads every copy before it posts the next."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.buf = torch.empty(3, dtype=torch.int32, pin_memory=self.cuda)
        self.event = torch.cuda.Event() if self.cuda else None

    def post(self, flag):
        self.buf.copy_(flag, non_blocking=self.cuda)
        if self.cuda:
            self.event.record(torch.cuda.current_stream(self.device))

    def read(self):
        if self.cuda:
            self.event.synchronize()
        gmres_solve_op.host_reads += 1
        return self.buf.tolist()


def _raise_if_bad(word):
    if word[1]:
        raise FloatingPointError(
            "GMRES residual is not finite: the operator or right-hand side "
            "produced NaN/inf"
        )


def _cycle(mv, st, target, tiny, m, lag, flags):
    """A cycle's Arnoldi steps; returns the host copy of its final flag
    word.  Before step j (j a multiple of lag, j >= lag - 1) the host
    reads the word after step j - lag (posted after every step that is a
    multiple of lag, and at the start when lag is 1) and stops when it says
    no system is active."""
    if lag == 1:
        flags.post(st.flag)
    for j in range(m):
        if j % lag == 0 and j >= lag - 1:
            word = flags.read()
            _raise_if_bad(word)
            if not word[0]:
                break
        arnoldi_step(st, mv(st.V[:, j]), j, target, tiny)
        gmres_solve_op.steps_issued += 1
        if j % lag == 0:
            flags.post(st.flag)
    else:
        if (m - 1) % lag:
            flags.post(st.flag)
        word = flags.read()
        _raise_if_bad(word)
    gmres_solve_op.steps_run += word[2]
    return word


def _gmres_cgs2(mv, diag, b, tol, m, maxiter, x0, lag=None):
    rdt = b.real.dtype
    n_sys = b.shape[0]
    tiny = float(torch.finfo(rdt).tiny) ** 0.5
    if lag is None:
        lag = _LAG_CUDA if b.device.type == "cuda" else 1
    b_pre = b / diag
    bnorm = torch.linalg.vector_norm(b_pre, dim=-1)
    target = tol * bnorm  # a non-finite right-hand side marks the word non-finite
    flags = _FlagReader(b.device)

    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).expand_as(b).clone()
    nsteps = torch.zeros(n_sys, dtype=torch.int32, device=b.device)
    for _ in range(maxiter):
        st = arnoldi_state(b_pre - mv(x) / diag, diag, target, m)
        word = _cycle(mv, st, target, tiny, m, lag, flags)
        # back-substitution on the rotated (upper-triangular) system; y is 0
        # past the steps that ran
        y = backsolve(st.R, st.g, st.flag, tiny)
        x = x + (y[:, None, :] @ st.V[:, :m])[:, 0]
        nsteps += st.steps
        resid = st.resid
        if not word[0]:
            break
    return x, resid * _inv_or_zero(bnorm, tiny), nsteps
