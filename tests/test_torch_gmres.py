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
equals the loop it replaced.
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
    _slices,
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


@pytest.mark.parametrize("n_sys,n", [(4, 16384), (4, 45920), (1, 369664), (1, 1001),
                                     (1, 12288), (200, 7)])
def test_kernel_slices_cover_n(n_sys, n):
    """K6's slices of n: cover n, at most one slice of padding, and as many
    entries a thread as keep two waves of CTAs (the H100's 132 SMs)."""
    ept, nblk = _slices(n_sys, n, 132)
    assert ept in (1, 2, 4)
    span = gmres_step._THREADS * ept
    assert (nblk - 1) * span < n <= nblk * span
    if ept > 1:
        assert n_sys * nblk >= 2 * 132
