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
kernel's oracle.  The step is one cooperative launch whose grid and
shared-memory layout `_plan` sets from the shapes and the card alone (its
co-resident CTAs and shared memory, `_capacity`): K x n cut into one
contiguous slice a CTA, the tile of V resident in shared memory or
streamed through a ring of bulk copies.
"""

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from . import kernels

# csrc/gmres_step.cu's constants
_THREADS = 288  # a CTA: 8 consumer warps and the producer warp (kThreads)
_SLOTS = 64  # mbarrier pairs: ring stages or resident slots (kSlots)
_RB_MAX = 32  # rows a stage (kRbMax)
_J_RED = 128  # rows of the CTA-local reduction (kJRed)
_T_RED = 4096  # its most partials a value (kTRed)
_RING_MAX = 8  # stages of the ring at most


def _fixed_smem(elt):
    """Shared memory before x, s and the tile (csrc/gmres_step.cu Smem::
    kFixed): the mbarriers, the CTA-local h, the warps' staged h, the norms'
    scratch."""
    return 2 * _SLOTS * 8 + 2 * 2 * _J_RED * elt + 8 * 2 * _RB_MAX * elt + 256


class K6Plan(NamedTuple):
    """The step's launch: `grid` CTAs, systems in rounds of `per_round`,
    slice boundaries multiples of `unit` entries, `lmax` entries at most a
    slice, stages of `rb` rows x `cw` entries (`row_bytes` a stage row),
    each `boxes` boxes of V's tensor map, a piece each (0: a row's pieces
    side by side, copied a row and piece at a time, where n entries are not
    a multiple of 16 bytes), the ring's `stages`, the tile resident while j + 1 <=
    `resident_rows`, at most `max_pieces` partials summed into a value, x
    and s in shared memory (`x_smem`) or a scratch, `smem` bytes of dynamic
    shared memory."""

    grid: int
    per_round: int
    rounds: int
    unit: int
    lmax: int
    cw: int
    rb: int
    row_bytes: int
    stages: int
    boxes: int
    resident_rows: int
    max_pieces: int
    x_smem: bool
    smem: int


def _round_cut(kr, n, grid, unit):
    """(entries N, CTAs with a slice, slice units) of a round of kr systems
    (csrc/gmres_step.cu round_at)."""
    big_n = kr * n
    return big_n, min(grid, max(kr, -(-big_n // 32))), -(-big_n // unit)


def _slice_lo(b, big_n, ga, nu, unit):
    """The first entry of CTA b's slice of a round (csrc slice_lo)."""
    return big_n if b >= ga else min(big_n, unit * (b * nu // ga))


def _slice_of(f, ga, nu, unit):
    """The CTA whose slice holds entry f of a round (csrc slice_of)."""
    return ((f // unit + 1) * ga - 1) // nu


def _tile_fits(rows, rb, chunks, stage, row_bytes, area):
    """Whether rows 0..rows-1 of a tile lie in shared memory whole: slot
    (g, c) at (g chunks + c) stage bytes, at most _SLOTS slots; the last
    slot takes the last group's rows of row_bytes each (row copies), or
    the whole stage (row_bytes 0: boxes of the tensor map)."""
    groups = -(-rows // rb)
    last = (rows - (groups - 1) * rb) * row_bytes or stage
    return groups * chunks <= _SLOTS and (groups * chunks - 1) * stage + last <= area


def _ring_area(elt, lmax, x_smem, smem):
    """Shared memory left to the ring / tile: after the fixed scratch and
    x and s (in shared memory), 128-byte aligned (csrc `ring`)."""
    used = _fixed_smem(elt) + (2 * lmax * elt if x_smem else 0)
    return smem - -(-used // 128) * 128


@lru_cache(maxsize=256)
def _plan(n_sys, n, elt, n_sm, capacity, smem):
    """K6's launch for K = n_sys systems of n unknowns of `elt`-byte complex
    entries on a card of n_sm SMs holding `capacity` CTAs at once with
    `smem` bytes of shared memory a CTA.  The grid fills the card whenever
    K n >= 32 n_sm (a CTA takes 32 entries at least) and holds a CTA a
    system at least, so that a slice spans at most two systems (K above the
    capacity goes in rounds).  A slice is cut in chunks of equal width of
    at most 2 KB (a tensor-map box's width), narrower where a stage of them
    would exceed a third of the ring's room; a stage holds 32, 24, 16 or 8
    rows, whichever keeps the most rows of the tile resident (the longer on
    a tie)."""
    unit = 2 if elt == 8 else 1
    per_round = min(n_sys, capacity)
    rounds = -(-n_sys // per_round)
    grid = min(capacity, max(per_round, -(-(per_round * n) // 32)))
    lmax, max_pieces, straddle = 0, 0, False
    for kr in {per_round, n_sys - (rounds - 1) * per_round}:
        big_n, ga, nu = _round_cut(kr, n, grid, unit)
        lmax = max(lmax, min(big_n, unit * -(-nu // ga)))
        for k in range(kr):
            pieces = (_slice_of(k * n + n - 1, ga, nu, unit) - _slice_of(k * n, ga, nu, unit)
                      + 1)
            max_pieces = max(max_pieces, pieces)
        for b in range(ga):
            lo, hi = _slice_lo(b, big_n, ga, nu, unit), _slice_lo(b + 1, big_n, ga, nu, unit)
            straddle |= hi > lo and (hi - 1) // n != lo // n
    x_smem = 2 * lmax * elt <= (smem - _fixed_smem(elt)) // 2
    area = _ring_area(elt, lmax, x_smem, smem)
    pad = 4 if elt == 8 else 0  # a complex64 row piece copied from its 16-byte boundary
    boxes = (2 if straddle else 1) if n * elt % 16 == 0 else 0
    best = None
    for rb in (32, 24, 16, 8):  # the most resident rows; ties: the longer stage
        cw_max = min(lmax + (lmax % unit), 2048 // elt)
        if rb * (cw_max + pad) * elt > area // 3:
            cw_max = max(unit, ((area // 3) // (rb * elt) - pad) // unit * unit)
        chunks = -(-lmax // cw_max)
        cw = -(-lmax // (chunks * unit)) * unit  # chunks of equal width
        row_bytes = (cw + (0 if boxes else pad)) * elt
        stage = (boxes or 1) * rb * row_bytes
        resident = 0
        while _tile_fits(resident + 1, rb, chunks, stage, 0 if boxes else row_bytes, area):
            resident += 1
        if best is None or resident > best[0]:
            best = (resident, rb, cw, row_bytes, min(_RING_MAX, area // stage))
    resident, rb, cw, row_bytes, stages = best
    return K6Plan(grid, per_round, rounds, unit, lmax, cw, rb, row_bytes, stages, boxes,
                  resident, max_pieces, x_smem, smem)


@lru_cache(maxsize=16)
def _capacity(dbl, index):
    """(CTAs the card holds at once, SMs, shared memory a CTA) of the step's
    kernel on card `index` at its whole shared memory (the CUDA occupancy
    calculator), cached per (dtype, card)."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        err = kernels.library().bhs_arnoldi_capacity(int(dbl), ctypes.addressof(out))
    blocks, n_sm, smem = out
    if err != 0 or blocks < 1:
        raise RuntimeError(f"arnoldi_step: occupancy query failed (CUDA error {err}, "
                           f"{blocks} CTAs an SM)")
    return blocks * n_sm, n_sm, smem


def _cuda_plan(n_sys, n, dtype, device):
    """The step's plan on a CUDA device."""
    dbl = dtype == torch.complex128
    index = device.index if device.index is not None else torch.cuda.current_device()
    capacity, n_sm, smem = _capacity(dbl, index)
    return _plan(n_sys, n, 16 if dbl else 8, n_sm, capacity, smem)


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
    rwork: torch.Tensor  # the kernel's real scratch (its barrier counter zeroed)
    ept: int  # entries of the longest slice (a CTA's), 0 on the CPU
    nblk: int  # slices of K x n: the step's CTAs, 0 on the CPU


def _inv_or_zero(a, tiny):
    return torch.where(a > tiny, 1.0 / torch.clamp(a, min=tiny), torch.zeros_like(a))


def _flag_of(resid, target, j_run):
    """The flag word of a state: any resid > target, any resid (or target)
    non-finite, j_run."""
    bad = ~(torch.isfinite(resid).all() & torch.isfinite(target).all())
    return torch.stack([(resid > target).any().to(torch.int32), bad.to(torch.int32),
                        j_run.to(torch.int32)])


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
    n_c, n_r, lmax, grid = 0, 0, 0, 0
    if r.device.type == "cuda":
        p = _cuda_plan(n_sys, n, r.dtype, r.device)
        lmax, grid = p.lmax, p.grid
        # partial dots [2, grid, 2, m+1], h1 and h2 [K, 2, m+1], hr[j] [K], x
        # and s where they spill [grid, 2, lmax]; 16 bytes of the barrier's
        # counter, then the partial norms [rounds, grid, 2]
        n_c = ((2 * grid * 2 + 2 * n_sys) * (m + 1) + n_sys
               + (0 if p.x_smem else grid * 2 * lmax))
        n_r = 16 // beta.element_size() + p.rounds * grid * 2
    cwork = torch.empty((n_c,), **kw)
    rwork = torch.zeros((n_r,), dtype=beta.dtype, device=r.device)
    return ArnoldiState(V, torch.zeros((n_sys, m, m), **kw), g, Q, beta,
                        torch.zeros(n_sys, dtype=torch.int32, device=r.device), flag,
                        diag.expand(n_sys, n).contiguous(), cwork, rwork, lmax, grid)


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
    tensors it launches csrc/gmres_step.cu (one cooperative launch with the
    state's plan, counted in `arnoldi_step.launches`) or raises."""
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
    p = _cuda_plan(n_sys, n, w.dtype, w.device)
    kernels.launch("bhs_arnoldi_step", st.V, st.R, st.g, st.Q, st.resid, st.steps, st.flag,
                   w.contiguous(), st.diag, target.contiguous(), st.cwork, st.rwork, n_sys, n,
                   m1 - 1, j, p.grid, p.per_round, p.unit, p.lmax, p.cw, p.rb, p.stages,
                   p.resident_rows, p.max_pieces, int(p.x_smem), p.boxes, p.smem, float(tiny),
                   int(w.dtype == torch.complex128))
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
    (one launch, a CTA a system, counted in `backsolve.launches`) or
    raises."""
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
