"""The port's GMRES step loop (ops/gmres.py) and K6's plain versions
(ops/gmres_step.py) on the CPU.

The loop with the plain step is held to the JAX package's
`gmres_solve_op(..., with_info=True)` on seeded numpy systems (n 40-300,
K 1 and 3, cold and warm, a basis small enough to force restarts): in
complex128 x within 1e-10 of its largest entry, relres within 1e-12 and
the iterations equal; in complex64 x within 1e-4 (float32 keeps ~7 digits,
and the two sum in another order).  The lag of the host's reads of the
flag word changes nothing but the matvecs past convergence: the results
are bit for bit the same at lags 1, 2, 4 and 8, the matvecs are those the
lag's schedule gives, and the reads at most ceil(steps / lag) plus one a
cycle.  A masked step changes no state tensor; the plain back-substitution
equals the loop it replaced; K6's launch plan cuts K x n over the card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from biem_helmholtz_sphere_tpu.ops import cplx as j_cplx
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu_torch.ops import gmres, gmres_step
from biem_helmholtz_sphere_tpu_torch.ops.gmres import gmres_solve_op
from biem_helmholtz_sphere_tpu_torch.ops.gmres_step import (
    _backsolve_plain,
    arnoldi_state,
    arnoldi_step,
)

LAGS = (1, 2, 4, 8)
TORCH_OF = {np.complex128: torch.complex128, np.complex64: torch.complex64}


def _system(seed, n_sys, n, cdt):
    """A diagonally dominant complex system [K, n, n], b [K, n] and a warm
    start near the solution."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(n_sys, n, n)) + 1j * rng.normal(size=(n_sys, n, n))
         + np.eye(n) * (2.2 * np.sqrt(n) + 1j)).astype(cdt)
    b = (rng.normal(size=(n_sys, n)) + 1j * rng.normal(size=(n_sys, n))).astype(cdt)
    x0 = (np.linalg.solve(a.astype(np.complex128), b[..., None])[..., 0]
          + 1e-3 * rng.normal(size=(n_sys, n))).astype(cdt)
    return a, b, x0


def _torch_solve(a, b, x0=None, restart=None, lag=None, counter=None):
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    diag = torch.diagonal(at, dim1=-2, dim2=-1)

    def mv(v):
        if counter is not None:
            counter[0] += 1
        return (at @ v[..., None])[..., 0]

    f32 = bt.dtype == torch.complex64
    m = max(1, min(restart or (48 if f32 else 192), bt.shape[-1]))
    x0t = None if x0 is None else torch.as_tensor(x0)
    return gmres._gmres_cgs2(mv, diag, bt, 3e-5 if f32 else 1e-11, m, 20, x0t, lag=lag)


def _jax_solve(a, b, x0=None, restart=None):
    rdt = np.float32 if a.dtype == np.complex64 else np.float64

    def c(v):
        return C(jnp.asarray(v.real, rdt), jnp.asarray(v.imag, rdt))

    ac = c(a)
    diag = np.diagonal(a, axis1=-2, axis2=-1)
    x, relres, iters = j_cplx.gmres_solve_op(
        lambda v: j_cplx.matvec(ac, v), c(diag), c(b), restart=restart,
        x0=None if x0 is None else c(x0), with_info=True)
    return x.to_numpy(), np.asarray(relres), np.asarray(iters)


@pytest.mark.parametrize("cdt", [np.complex128, np.complex64])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("n_sys,n,restart", [(1, 40, 6), (3, 120, 8)])
def test_gmres_matches_the_jax_package(cdt, warm, n_sys, n, restart):
    a, b, x0 = _system(11 + n, n_sys, n, cdt)
    x0 = x0 if warm else None
    jx, jrel, jit = _jax_solve(a, b, x0, restart)
    x, rel, it = _torch_solve(a, b, x0, restart)
    scale = np.abs(jx).max()
    if cdt == np.complex128:
        assert np.abs(x.numpy() - jx).max() <= 1e-10 * scale
        assert np.abs(rel.numpy() - jrel).max() <= 1e-12
        np.testing.assert_array_equal(it.numpy(), jit)
        assert float(rel.max()) <= 1e-11
    else:
        assert np.abs(x.numpy() - jx).max() <= 1e-4 * scale
        assert float(rel.max()) <= 3e-5
    if not warm:
        assert int(it.max()) > restart  # the basis forced a restart


def _cycles_of(monkeypatch):
    """Record each cycle's steps that ran (the final word's j_run)."""
    runs, cycle = [], gmres._cycle

    def recorded(*args):
        word = cycle(*args)
        runs.append(word[2])
        return word

    monkeypatch.setattr(gmres, "_cycle", recorded)
    return runs


def _issued(j_run, m, lag):
    """Steps a cycle issues at `lag` when j_run of them run: it stops before
    the first step j that is a multiple of lag with j - lag + 1 >= j_run."""
    if j_run >= m:
        return m
    return min(m, lag * math.ceil((j_run + lag - 1) / lag))


@pytest.mark.parametrize("cdt", [np.complex128, np.complex64])
def test_lags_give_the_same_bits_and_a_schedule_of_matvecs(monkeypatch, cdt):
    a, b, _ = _system(5, 3, 150, cdt)
    m = 7
    ref = None
    for lag in LAGS:
        runs = _cycles_of(monkeypatch)
        calls = [0]
        reads0, issued0 = gmres_solve_op.host_reads, gmres_solve_op.steps_issued
        out = _torch_solve(a, b, restart=m, lag=lag, counter=calls)
        monkeypatch.undo()
        reads = gmres_solve_op.host_reads - reads0
        issued = [_issued(r, m, lag) for r in runs]
        assert calls[0] == len(runs) + sum(issued)  # a residual matvec a cycle
        assert gmres_solve_op.steps_issued - issued0 == sum(issued)
        assert reads <= sum(math.ceil(i / lag) + 1 for i in issued)
        if ref is None:
            ref, ref_runs = out, runs
            assert len(runs) > 1 and min(runs) >= 1
            continue
        assert runs == ref_runs
        for got, want in zip(out, ref):
            assert torch.equal(torch.view_as_real(got) if got.is_complex() else got,
                               torch.view_as_real(want) if want.is_complex() else want)


@pytest.mark.parametrize("lag", LAGS)
def test_host_reads_per_solve(lag, monkeypatch):
    """At most ceil(steps / lag) reads of the flag word plus one a cycle,
    for a cold solve with restarts and a warm solve that stops early."""
    a, b, x0 = _system(7, 1, 90, np.complex128)
    for start in (None, x0):
        runs = _cycles_of(monkeypatch)
        reads0, issued0 = gmres_solve_op.host_reads, gmres_solve_op.steps_issued
        _torch_solve(a, b, start, restart=10, lag=lag)
        monkeypatch.undo()
        issued = gmres_solve_op.steps_issued - issued0
        assert gmres_solve_op.host_reads - reads0 <= math.ceil(issued / lag) + len(runs)


def _state(seed, n_sys=2, n=33, m=5, cdt=torch.complex128, steps=2):
    """A state after `steps` plain steps of a random system, its target,
    its matvec of V[:, steps] and its operator."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.normal(size=(n_sys, n, n)) + 1j * rng.normal(size=(n_sys, n, n))
                        + np.eye(n) * 8.0, dtype=cdt)
    r = torch.as_tensor(rng.normal(size=(n_sys, n)) + 1j * rng.normal(size=(n_sys, n)),
                        dtype=cdt)
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    target = torch.full((n_sys,), 1e-30, dtype=r.real.dtype)
    tiny = float(torch.finfo(r.real.dtype).tiny) ** 0.5
    st = arnoldi_state(r, diag, target, m)
    for j in range(steps):
        arnoldi_step(st, (a @ st.V[:, j, :, None])[..., 0], j, target, tiny)
    return st, target, tiny, (a @ st.V[:, steps, :, None])[..., 0]


def _tensors(st):
    return [t for t in st if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("why", ["converged", "non-finite"])
def test_a_masked_step_changes_nothing(why):
    st, target, tiny, w = _state(3)
    assert int(st.flag[2]) == 2
    if why == "converged":
        target = torch.full_like(target, 1e30)
        st.flag[0] = 0  # as the last step would have written it
    else:
        st.resid[1] = float("nan")
        st.flag[1] = 1
    before = [t.clone() for t in _tensors(st)]
    arnoldi_step(st, w, 2, target, tiny)
    for got, want in zip(_tensors(st), before):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_an_active_step_runs_and_counts():
    st, target, tiny, w = _state(4, steps=1)
    v2 = st.V[:, 2].clone()
    arnoldi_step(st, w, 1, target, tiny)
    assert st.flag.tolist() == [1, 0, 2]
    assert st.steps.tolist() == [2, 2]
    assert not torch.equal(st.V[:, 2], v2)
    # the basis stays orthonormal
    vv = st.V[:, :3].conj() @ st.V[:, :3].transpose(1, 2)
    assert float((vv - torch.eye(3, dtype=vv.dtype)).abs().max()) <= 1e-13


def _backsolve_loop(R, g, j_f, tiny):
    """The back-substitution of ops/gmres.py before K6 (a frozen copy)."""
    n_sys, m = R.shape[:2]
    y = torch.zeros((n_sys, m), dtype=R.dtype)
    for col in reversed(range(j_f)):
        s = (R[:, col + 1 : j_f, col] * y[:, col + 1 : j_f]).sum(-1)
        rll = R[:, col, col]
        scale = gmres_step._inv_or_zero(rll.abs(), tiny)
        y[:, col] = (g[:, col] - s) * (rll.conj() * (scale * scale))
    return y


@pytest.mark.parametrize("cdt", [torch.complex128, torch.complex64])
def test_plain_backsolve_equals_the_loop_it_replaced(cdt):
    rng = np.random.default_rng(9)
    n_sys, m = 3, 12
    R = torch.as_tensor(rng.normal(size=(n_sys, m, m)) + 1j * rng.normal(size=(n_sys, m, m))
                        + 4 * np.eye(m), dtype=cdt)
    g = torch.as_tensor(rng.normal(size=(n_sys, m + 1)) + 1j * rng.normal(size=(n_sys, m + 1)),
                        dtype=cdt)
    tiny = float(torch.finfo(R.real.dtype).tiny) ** 0.5
    for j_f in range(1, m + 1):
        flag = torch.tensor([0, 0, j_f], dtype=torch.int32)
        y = _backsolve_plain(R, g, flag, tiny)
        assert torch.equal(y, _backsolve_loop(R, g, j_f, tiny))
        assert not bool(y[:, j_f:].abs().any())


@pytest.mark.parametrize("elt", [8, 16])
@pytest.mark.parametrize("n_sys,n", [(4, 16384), (4, 45920), (1, 369664), (1, 1001),
                                     (1, 12288), (200, 7), (3, 4097)])
def test_k6_plan_cuts_the_card(n_sys, n, elt):
    """K6's plan (`_plan`) on an H100 (132 SMs, 232,448 bytes of shared
    memory a CTA) holding 1 or 2 of its CTAs an SM: every entry of K x n in
    exactly one CTA's slice of its round, a slice within lmax entries and
    two systems; every SM given work whenever K n >= 32 SMs; the grid
    within the co-resident capacity; the tile resident exactly while it
    fits the shared memory beside x, s and the fixed scratch (and the
    mbarrier slots), the ring's stages fitting it."""
    n_sm, smem = 132, 232448
    for capacity in (n_sm, 2 * n_sm):
        p = gmres_step._plan(n_sys, n, elt, n_sm, capacity, smem)
        assert 1 <= p.grid <= capacity
        assert p.rounds == -(-n_sys // p.per_round) and p.per_round <= p.grid
        if n_sys * n >= 32 * n_sm:
            assert p.grid >= n_sm
        for rho in range(p.rounds):
            kr = min(p.per_round, n_sys - rho * p.per_round)
            big_n, ga, nu = gmres_step._round_cut(kr, n, p.grid, p.unit)
            lo = [gmres_step._slice_lo(b, big_n, ga, nu, p.unit) for b in range(p.grid + 1)]
            assert lo[0] == 0 and lo[-1] == big_n
            sizes = np.diff(lo)
            assert (sizes >= 0).all() and sizes.max() <= p.lmax
            if n_sys * n >= 32 * n_sm and rho == 0:
                assert (sizes[:n_sm] > 0).all()
            for b in range(p.grid):
                if sizes[b]:  # at most two systems; slice_of finds it
                    assert (lo[b + 1] - 1) // n - lo[b] // n <= 1
                    for f in (lo[b], lo[b + 1] - 1):
                        assert gmres_step._slice_of(f, ga, nu, p.unit) == b
        fixed = gmres_step._fixed_smem(elt)
        xs = 2 * p.lmax * elt if p.x_smem else 0
        area = smem - -(-(fixed + xs) // 128) * 128
        assert area == gmres_step._ring_area(elt, p.lmax, p.x_smem, smem) > 0
        assert p.x_smem == (2 * p.lmax * elt <= (smem - fixed) // 2)
        chunks = -(-p.lmax // p.cw)
        assert p.cw % p.unit == 0 and p.cw * elt <= 2048
        # boxes of V's tensor map where a row is a multiple of 16 bytes: two a
        # stage where some slice spans two systems; else rows padded by 4
        assert p.boxes == (0 if n * elt % 16 else 2 if _straddles(p, n_sys, n) else 1)
        assert p.row_bytes == (p.cw + (0 if p.boxes or elt == 16 else 4)) * elt
        stage = (p.boxes or 1) * p.rb * p.row_bytes
        assert 2 <= p.stages <= gmres_step._SLOTS and p.stages * stage <= area
        last_row = 0 if p.boxes else p.row_bytes
        if p.resident_rows:
            assert gmres_step._tile_fits(p.resident_rows, p.rb, chunks, stage, last_row, area)
            groups = -(-p.resident_rows // p.rb)
            last = (p.resident_rows - (groups - 1) * p.rb) * last_row or stage
            assert groups * chunks <= gmres_step._SLOTS
            assert smem - area + (groups * chunks - 1) * stage + last <= smem
        assert not gmres_step._tile_fits(p.resident_rows + 1, p.rb, chunks, stage, last_row,
                                         area)


def _straddles(p, n_sys, n):
    """Whether some CTA's slice spans two systems in some round of plan p."""
    for rho in range(p.rounds):
        kr = min(p.per_round, n_sys - rho * p.per_round)
        big_n, ga, nu = gmres_step._round_cut(kr, n, p.grid, p.unit)
        for b in range(ga):
            lo = gmres_step._slice_lo(b, big_n, ga, nu, p.unit)
            hi = gmres_step._slice_lo(b + 1, big_n, ga, nu, p.unit)
            if hi > lo and (hi - 1) // n != lo // n:
                return True
    return False
