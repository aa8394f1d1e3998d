r"""Independent cross-solver oracle: Method of Fundamental Solutions.

A copy of biem_helmholtz_sphere_tpu.validation (numpy and scipy only; the
port imports nothing of the JAX package).  The reference validated its
BIEM against an external boundary-element package (bempp_cl_sphere.py:15-98
there); bempp-cl is not a dependency, so this module closes the same loop
with a self-contained *different numerical method*: the Method of
Fundamental Solutions (MFS).  Nothing here shares code with the BIEM
pipeline — no hyperspherical harmonics, no translation operators, no
repo special functions.  The only inputs are numpy, scipy.special.hankel1,
and the free-space Helmholtz Green's function, so an agreement between `mfs_uscat` and `biem(...).uscat`
on a *novel* configuration (one no stored golden covers) is genuine
independent evidence that both solved the same scattering problem.

Method: for each ball b place N_src fictitious monopole sources on an
interior sphere of radius ``src_depth * radii[b]`` and N_col collocation
points on the physical surface; solve the (overdetermined, complex)
least-squares system requiring the total field u_in + sum_j sigma_j
G(x, s_j) to satisfy the impedance condition
``alpha u + beta du/dn = 0`` at every collocation point.  The ansatz
satisfies the Helmholtz equation and the radiation condition exactly;
only the boundary condition is approximated, and its residual on a
*fresh* set of surface points is returned as the oracle's own accuracy
certificate (`MFSResult.bc_residual`).

Works in any dimension d >= 2 through the d-dimensional free-space
Green's function

    G_d(R) = (i/4) (k / (2 pi R))^nu  H^(1)_nu(k R),   nu = (d-2)/2,

which reduces to (i/4) H_0(kR) in 2D and e^{ikR}/(4 pi R) in 3D.
Radial derivative via d/dz [z^-nu H_nu(z)] = -z^-nu H_{nu+1}(z).

CPU-only, float64, seconds-scale by design: this is a validation
instrument, not a production path (use `biem` for that).
"""

from dataclasses import dataclass

import numpy as np
from scipy.special import hankel1

__all__ = ["MFSResult", "mfs_uscat", "sphere_points"]


def sphere_points(d, n, seed=0):
    """n quasi-uniform unit vectors on S^{d-1}, shape [n, d].

    d=2: exact uniform angles; d=3: Fibonacci spiral; d>=4: seeded
    random directions (the MFS least-squares system only needs
    reasonable coverage, and collocation is oversampled 2x vs sources).
    ``seed`` is an integer RNG seed (only used for d >= 4); callers that
    need several independent point sets pass distinct integers.

    >>> p = sphere_points(3, 100)
    >>> bool(np.allclose(np.linalg.norm(p, axis=1), 1.0))
    True
    """
    if d == 2:
        t = 2 * np.pi * np.arange(n) / n
        return np.stack([np.cos(t), np.sin(t)], axis=1)
    if d == 3:
        i = np.arange(n) + 0.5
        phi = np.pi * (np.sqrt(5.0) + 1) * i  # golden-angle spiral
        z = 1 - 2 * i / n
        r = np.sqrt(np.maximum(0.0, 1 - z * z))
        return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)
    rng = np.random.default_rng(int(seed))
    v = rng.standard_normal((n, d))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _green(d, k, diff):
    """G_d(|diff|) for diff [..., d]; returns complex [...]."""
    R = np.linalg.norm(diff, axis=-1)
    if d == 3:  # closed form (half-integer order hankel1 is slow)
        return np.exp(1j * k * R) / (4 * np.pi * R)
    nu = (d - 2) / 2.0
    return 0.25j * (k / (2 * np.pi * R)) ** nu * hankel1(nu, k * R)


def _green_normal(d, k, diff, normal):
    """n . grad_x G_d(x - s) with diff = x - s [..., d], normal [..., d]."""
    R = np.linalg.norm(diff, axis=-1)
    if d == 3:
        dG_dR = np.exp(1j * k * R) * (1j * k * R - 1) / (4 * np.pi * R**2)
    else:
        nu = (d - 2) / 2.0
        z = k * R
        # via d/dz [z^-nu H_nu(z)] = -z^-nu H_{nu+1}(z), z = kR:
        dG_dR = (
            -0.25j * k * (k / (2 * np.pi)) ** nu * z**-nu * hankel1(nu + 1, z) * k**nu
        )
    cosang = np.sum(diff * normal, axis=-1) / R
    return dG_dR * cosang


def _h0(d, z):
    """d-dim spherical Hankel h^(1)_0(z), the `shn1`/`point_source`
    normalization (special/_family.py:332-367): sqrt(pi/2) z^-nu
    H^(1)_nu(z), nu = (d-2)/2; closed form -i e^{iz}/z in 3D."""
    if d == 3:
        return -1j * np.exp(1j * z) / z
    nu = (d - 2) / 2.0
    return np.sqrt(np.pi / 2.0) * z**-nu * hankel1(nu, z)


def _h0p(d, z):
    """d/dz of _h0 via d/dz [z^-nu H_nu(z)] = -z^-nu H_{nu+1}(z)."""
    if d == 3:
        return np.exp(1j * z) * (z + 1j) / z**2
    nu = (d - 2) / 2.0
    return -np.sqrt(np.pi / 2.0) * z**-nu * hankel1(nu + 1, z)


@dataclass
class MFSResult:
    """Oracle solution: call `uscat(points)` with points [P, d]."""

    sources: np.ndarray  # [B*Ns, d]
    strengths: np.ndarray  # [B*Ns] complex
    bc_residual: float  # max BC defect on fresh surface pts / max|u_in|
    d: int
    k: float

    def uscat(self, points):
        """Scattered field at exterior points [P, d] -> complex [P]."""
        points = np.asarray(points, dtype=np.float64)
        diff = points[:, None, :] - self.sources[None, :, :]
        return _green(self.d, self.k, diff) @ self.strengths


def mfs_uscat(
    *,
    centers,
    radii,
    k,
    direction=None,
    source=None,
    alpha=1.0,
    beta=0.0,
    kind="outer",
    n_src=200,
    src_depth=0.5,
    seed=0,
):
    """Solve scattering off B hyperspheres by MFS.

    centers [B, d], radii [B], scalar k.  The incident wave is exactly
    one of:

    - ``direction`` [d] (normalized internally): plane wave e^{i k d.x},
      the `plane_wave` convention;
    - ``source`` [d]: monopole point source h^(1)_0(k |x - source|) in
      the `point_source` (n=0) normalization — the reference's
      point-source incidence (_biem.py:391-450) that the bempp oracle
      there never covered.

    alpha/beta: impedance BC  alpha u + beta du/dn = 0  (sound-soft for
    alpha=1, beta=0).  ``kind="inner"`` solves the interior problem for
    a SINGLE ball (fictitious sources placed *outside* at
    radius/src_depth; the ansatz is then regular inside).  ``seed`` is
    an integer RNG seed for the d>=4 point sets.  Returns an
    `MFSResult`; check `bc_residual` before trusting `uscat` — it
    bounds the oracle's own error by the usual BVP stability argument.

    >>> r = mfs_uscat(centers=np.zeros((1, 3)), radii=np.ones(1),
    ...               k=1.0, direction=np.array([1.0, 0, 0]))
    >>> bool(r.bc_residual < 1e-5)  # defaults: ~4e-6 certificate
    True
    """
    centers = np.asarray(centers, dtype=np.float64)
    radii = np.asarray(radii, dtype=np.float64)
    B, d = centers.shape
    k = float(k)
    alpha = complex(alpha)
    beta = complex(beta)
    n_col = 2 * n_src
    seed = int(seed)
    if (direction is None) == (source is None):
        raise ValueError(
            "give exactly one of direction= (plane wave) or source= (point source)"
        )
    if kind not in ("outer", "inner"):
        raise ValueError(f"kind must be 'outer' or 'inner', got {kind!r}")
    if kind == "inner" and B != 1:
        raise ValueError("kind='inner' oracle supports a single ball only")

    if direction is not None:
        direction = np.asarray(direction, dtype=np.float64)
        direction = direction / np.linalg.norm(direction)

        def u_in(x):  # [.., d] -> complex
            return np.exp(1j * k * (x @ direction))

        def du_in(x, nrm):  # normal derivative of the incident wave
            return 1j * k * (nrm @ direction) * u_in(x)

    else:
        source = np.asarray(source, dtype=np.float64)

        def u_in(x):
            R = np.linalg.norm(x - source, axis=-1)
            return _h0(d, k * R)

        def du_in(x, nrm):
            rel = x - source
            R = np.linalg.norm(rel, axis=-1)
            return _h0p(d, k * R) * k * np.sum(rel * nrm, axis=-1) / R

    # geometry: per-ball collocation (on surface) and fictitious sources
    # (inside for the exterior problem; outside for the interior one)
    col_dirs = sphere_points(d, n_col, seed=seed)
    src_dirs = sphere_points(d, n_src, seed=seed + 1)
    src_radii = (src_depth * radii) if kind == "outer" else (radii / src_depth)
    col = (centers[:, None, :] + radii[:, None, None] * col_dirs).reshape(-1, d)
    nrm = np.broadcast_to(col_dirs, (B, n_col, d)).reshape(-1, d)
    src = (centers[:, None, :] + src_radii[:, None, None] * src_dirs).reshape(-1, d)

    diff = col[:, None, :] - src[None, :, :]
    A = alpha * _green(d, k, diff)
    if beta != 0:
        A = A + beta * _green_normal(d, k, diff, nrm[:, None, :])
    rhs = -(alpha * u_in(col) + (beta * du_in(col, nrm) if beta != 0 else 0.0))
    strengths, *_ = np.linalg.lstsq(A, rhs, rcond=None)

    # accuracy certificate: BC defect at FRESH surface points (a
    # rotated/jittered point set, not the collocation nodes)
    test_dirs = sphere_points(d, n_col + 37, seed=seed + 2)
    if d <= 3:  # deterministic families need an explicit de-alias twist
        ang = 0.71
        c, s = np.cos(ang), np.sin(ang)
        rot = np.eye(d)
        rot[:2, :2] = [[c, -s], [s, c]]
        test_dirs = test_dirs @ rot
    tst = (centers[:, None, :] + radii[:, None, None] * test_dirs).reshape(-1, d)
    tnrm = np.broadcast_to(test_dirs, (B, n_col + 37, d)).reshape(-1, d)
    tdiff = tst[:, None, :] - src[None, :, :]
    tot = alpha * (u_in(tst) + _green(d, k, tdiff) @ strengths)
    if beta != 0:
        tot = tot + beta * (
            du_in(tst, tnrm) + _green_normal(d, k, tdiff, tnrm[:, None, :]) @ strengths
        )
    resid = float(np.max(np.abs(tot)) / np.max(np.abs(u_in(tst))))
    return MFSResult(sources=src, strengths=strengths, bc_residual=resid, d=d, k=k)
