"""K6: one Arnoldi step of the GMRES solve, and a cycle's back-substitution.

Port of biem_helmholtz_sphere_tpu/ops/cplx.py::_gmres_cgs2's `step` (the
`step_work` under its lax.cond, `:569-607`, with pre_mv's Jacobi division)
and `back` (`:627-646`).  A cycle's state (`ArnoldiState`) lives on the
device, with a flag word int32 [3]: any system active, any residual
non-finite, the steps that ran.  A step that finds no system active, or a
residual non-finite, leaves every state tensor unchanged, so the host may
queue steps ahead of its reads of the word (ops/gmres.py).

`arnoldi_step` and `backsolve` launch csrc/gmres_step.cu on CUDA tensors
(counted in `arnoldi_step.launches` / `backsolve.launches`) or raise; on
CPU tensors they run `_arnoldi_step_plain` / `_backsolve_plain`, the
kernel's oracle.
"""

from typing import NamedTuple

import torch

from . import kernels

_THREADS = 256  # threads of a CTA (= csrc/gmres_step.cu kThreads)


class ArnoldiState(NamedTuple):
    """A GMRES cycle's state, updated in place by each step."""

    V: torch.Tensor  # [K, m+1, n] the Krylov basis
    R: torch.Tensor  # [K, m, m] the rotated Hessenberg, R[k, col, row]
    g: torch.Tensor  # [K, m+1] the rotated right-hand side
    Q: torch.Tensor  # [K, m+1, m+1] the product of the Givens rotations
    resid: torch.Tensor  # [K] real: the rotation-carried residual estimate
    steps: torch.Tensor  # [K] int32: steps each system was above its target
    flag: torch.Tensor  # int32 [3]: any active, any resid non-finite, steps run
    diag: torch.Tensor  # [K, n] the Jacobi diagonal (contiguous)
    cwork: torch.Tensor  # the kernel's complex scratch (empty on the CPU)
    rwork: torch.Tensor  # the kernel's real scratch
    ept: int  # entries of n a thread
    nblk: int  # slices of n a pass


def _inv_or_zero(a, tiny):
    return torch.where(a > tiny, 1.0 / torch.clamp(a, min=tiny), torch.zeros_like(a))


def _flag_of(resid, target, j_run):
    """The flag word of a state: any resid > target, any resid (or target)
    non-finite, j_run."""
    bad = ~(torch.isfinite(resid).all() & torch.isfinite(target).all())
    return torch.stack([(resid > target).any().to(torch.int32), bad.to(torch.int32),
                        j_run.to(torch.int32)])


def _slices(n_sys, n, n_sm):
    """(entries a thread, slices of n): the most entries a thread that keep
    two waves of CTAs a pass on a card of n_sm multiprocessors, else one."""
    for ept in (4, 2):
        nblk = -(-n // (_THREADS * ept))
        if n_sys * nblk >= 2 * n_sm:
            return ept, nblk
    return 1, -(-n // _THREADS)


def arnoldi_state(r, diag, target, m):
    """The state at a cycle's start from the preconditioned residual r
    [K, n]: V[:, 0] = r / |r| (0 where |r| <= tiny), g[:, 0] = |r|, Q = I,
    R = 0, resid = |r|, steps 0, the flag word of resid."""
    n_sys, n = r.shape
    tiny = float(torch.finfo(r.real.dtype).tiny) ** 0.5
    kw = dict(dtype=r.dtype, device=r.device)
    beta = torch.linalg.vector_norm(r, dim=-1)
    V = torch.zeros((n_sys, m + 1, n), **kw)
    V[:, 0] = r * _inv_or_zero(beta, tiny)[:, None]
    g = torch.zeros((n_sys, m + 1), **kw)
    g[:, 0] = beta
    Q = torch.eye(m + 1, **kw).expand(n_sys, m + 1, m + 1).clone()
    flag = _flag_of(beta, target, torch.zeros((), dtype=torch.int32, device=r.device))
    ept, nblk = 1, 0
    if r.device.type == "cuda":
        n_sm = torch.cuda.get_device_properties(r.device).multi_processor_count
        ept, nblk = _slices(n_sys, n, n_sm)
    cwork = torch.empty(
        (n_sys * (n + (m + 1) * nblk + 3 * (m + 1)) if nblk else 0,), **kw)
    rwork = torch.empty((n_sys * (nblk + 1) if nblk else 0,), dtype=beta.dtype,
                        device=r.device)
    return ArnoldiState(V, torch.zeros((n_sys, m, m), **kw), g, Q, beta,
                        torch.zeros(n_sys, dtype=torch.int32, device=r.device), flag,
                        diag.expand(n_sys, n).contiguous(), cwork, rwork, ept, nblk)


def _arnoldi_step_plain(st, w, j, target, tiny):
    """K6's plain version (and its CPU path): step j of every system on w
    = the matvec of V[:, j], in place; nothing changes when the flag word
    says no system is active or a residual is non-finite."""
    active, bad, _ = st.flag.tolist()
    if not active or bad:
        return
    V, R, g, Q = st.V, st.R, st.g, st.Q
    st.steps.add_((st.resid > target).to(torch.int32))
    w = w / st.diag
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
    vj_ = (hn * inv_r).to(V.dtype)
    qj, qj1 = Q[:, j].clone(), Q[:, j + 1].clone()
    Q[:, j] = uj[:, None] * qj + vj_[:, None] * qj1
    Q[:, j + 1] = qj1 * uj.conj()[:, None] - qj * vj_[:, None]
    hr[:, j] = rr
    R[:, j] = hr[:, : R.shape[-1]]
    gj = g[:, j].clone()
    g[:, j] = uj * gj
    g[:, j + 1] = -gj * vj_
    st.resid.copy_((gj * vj_).abs())
    st.flag.copy_(_flag_of(st.resid, target, st.flag[2] + 1))


def arnoldi_step(st, w, j, target, tiny):
    """K6 wrapper: Arnoldi step j (0 <= j < m) of the state `st`
    (`arnoldi_state`) on w [K, n] = the matvec of st.V[:, j], in place;
    target [K] real.  On CPU tensors this runs the plain version; on CUDA
    tensors it launches csrc/gmres_step.cu (one call, counted in
    `arnoldi_step.launches`) or raises."""
    if w.device.type == "cpu":
        return _arnoldi_step_plain(st, w, j, target, tiny)
    if w.device.type != "cuda":
        raise RuntimeError(f"arnoldi_step: unsupported device {w.device}")
    if w.dtype != st.V.dtype or w.dtype not in kernels.REAL_OF:
        raise TypeError(f"arnoldi_step: w {w.dtype}, state {st.V.dtype}")
    n_sys, m1, n = st.V.shape
    if w.shape != (n_sys, n) or not 0 <= j < m1 - 1 or target.shape != (n_sys,):
        raise ValueError(f"arnoldi_step: w {tuple(w.shape)}, V {tuple(st.V.shape)}, j {j}, "
                         f"target {tuple(target.shape)}")
    kernels.launch("bhs_arnoldi_step", st.V, st.R, st.g, st.Q, st.resid, st.steps, st.flag,
                   w.contiguous(), st.diag, target.contiguous(), st.cwork, st.rwork, n_sys, n,
                   m1 - 1, j, st.nblk, st.ept, float(tiny), int(w.dtype == torch.complex128))
    arnoldi_step.launches += 1


arnoldi_step.launches = 0


def _backsolve_plain(R, g, flag, tiny):
    """The back-substitution's plain version (and its CPU path): y [K, m]
    with R[:, :j_f, :j_f]'s upper triangle y = g[:, :j_f], j_f = flag[2],
    and y = 0 past j_f."""
    n_sys, m, _ = R.shape
    j_f = int(flag[2])
    y = torch.zeros((n_sys, m), dtype=R.dtype, device=R.device)
    for col in reversed(range(j_f)):
        s = (R[:, col + 1 : j_f, col] * y[:, col + 1 : j_f]).sum(-1)
        rll = R[:, col, col]
        scale = _inv_or_zero(rll.abs(), tiny)
        y[:, col] = (g[:, col] - s) * (rll.conj() * (scale * scale))
    return y


def backsolve(R, g, flag, tiny):
    """Back-substitution wrapper: y [K, m] from R [K, m, m], g [K, m+1] and
    the flag word's j_f (on the device: no host read).  On CPU tensors this
    runs the plain version; on CUDA tensors it launches csrc/gmres_step.cu
    (one launch, counted in `backsolve.launches`) or raises."""
    if R.device.type == "cpu":
        return _backsolve_plain(R, g, flag, tiny)
    if R.device.type != "cuda":
        raise RuntimeError(f"backsolve: unsupported device {R.device}")
    if R.dtype not in kernels.REAL_OF or g.dtype != R.dtype:
        raise TypeError(f"backsolve: R {R.dtype}, g {g.dtype}")
    n_sys, m, _ = R.shape
    if g.shape != (n_sys, m + 1) or flag.dtype != torch.int32:
        raise ValueError(f"backsolve: R {tuple(R.shape)}, g {tuple(g.shape)}, flag {flag.dtype}")
    y = torch.empty((n_sys, m), dtype=R.dtype, device=R.device)
    kernels.launch("bhs_gmres_backsolve", R.contiguous(), g.contiguous(), flag, y, n_sys, m,
                   float(tiny), int(R.dtype == torch.complex128))
    backsolve.launches += 1
    return y


backsolve.launches = 0
