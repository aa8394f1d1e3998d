"""The port's remaining public surfaces against the JAX package's, on the
CPU from the same numpy inputs: the coordinate constructors and the tree
drawing, `node_by_id`, the harmonics' phase marker, degree index and radial factors,
`orthonormal_jacobi_all`, `potential_coef`, and `utils`; and every name of
the JAX subpackages' public lists present in the port's.

Tolerances: the same recurrences in float64 on both sides, 1e-12 of each
entry (relative above 1); the linear solve 1e-12 of the largest entry.
The JAX package's radial factors and `potential_coef` values are committed in
tests/golden/test_torch_surfaces.npz (`jax_golden`, `python
tools/torch_golden_from_jax.py --tests`).
"""

import importlib
import time

import _jax_golden
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu_torch import coords, harmonics, special, utils
from biem_helmholtz_sphere_tpu_torch.biem import potential_coef

j_coords = importlib.import_module("biem_helmholtz_sphere_tpu.coords")
j_harmonics = importlib.import_module("biem_helmholtz_sphere_tpu.harmonics")
j_special = importlib.import_module("biem_helmholtz_sphere_tpu.special")
j_layer = importlib.import_module("biem_helmholtz_sphere_tpu.biem._layer")
j_utils = importlib.import_module("biem_helmholtz_sphere_tpu.utils")

F64 = dict(dtype=torch.float64)
SUBPACKAGES = ("coords", "harmonics", "special", "translation", "biem", "utils", "parallel",
               "validation", "plot", "gui", "cli")


def _public(mod):
    """A module's public names: its __all__, else the names it defines or
    re-exports from its own package."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n in dir(mod) if not n.startswith("_")
            and getattr(getattr(mod, n), "__module__", "").startswith(mod.__name__)}


def _close(got, ref, tol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert (np.isfinite(got) == np.isfinite(ref)).all()
    fin = np.isfinite(ref)
    return bool((np.abs(got - ref)[fin] <= tol * np.maximum(np.abs(ref)[fin], 1.0)).all())


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_every_jax_public_name_is_in_the_port(name):
    jax_mod = importlib.import_module(f"biem_helmholtz_sphere_tpu.{name}")
    port = importlib.import_module(f"biem_helmholtz_sphere_tpu_torch.{name}")
    missing = _public(jax_mod) - set(port.__all__)
    assert not missing, missing
    assert all(hasattr(port, n) for n in port.__all__)


@pytest.mark.parametrize("d", range(2, 9))
def test_create_functions_give_the_jax_trees(d):
    """create_standard, create_standard_prime and create_hopf (powers of
    two; ValueError elsewhere, as in the JAX package) give the JAX
    package's branching string and the same node kinds, ids and axes."""
    for name in ("create_standard", "create_standard_prime", "create_hopf"):
        if name == "create_hopf" and d & (d - 1):
            with pytest.raises(ValueError):
                getattr(j_coords, name)(d)
            with pytest.raises(ValueError):
                getattr(coords, name)(d)
            continue
        got, ref = getattr(coords, name)(d), getattr(j_coords, name)(d)
        assert got.branching_types_expression_str == ref.branching_types_expression_str
        assert got.c_ndim == ref.c_ndim == d
        assert [(n.kind, n.nid, n.axes) for n in got.nodes] == [
            (n.kind, n.nid, n.axes) for n in ref.nodes]
    with pytest.raises(ValueError):
        coords.create_standard(1)


@pytest.mark.parametrize("seed", range(10))
def test_create_random_draws_the_jax_tree(seed):
    """One seed gives one tree in both packages, for d = 2..8, whether the
    seed is an int or a numpy Generator."""
    for d in range(2, 9):
        ref = j_coords.create_random(d, seed).branching_types_expression_str
        assert coords.create_random(d, seed).branching_types_expression_str == ref
        got = coords.create_random(d, np.random.default_rng(seed))
        assert got.branching_types_expression_str == ref and got.c_ndim == d


def test_draw_labels_the_nodes_as_jax():
    """SphericalCoordinates.draw on the Agg backend: the same node labels
    at the same places."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for s in ("a", "ba", "caa", "bcbaa"):
        got = coords.create_from_branching_types(s).draw()
        ref = j_coords.create_from_branching_types(s).draw()
        assert [(t.get_text(), t.xy) for t in got.texts] == [
            (t.get_text(), t.xy) for t in ref.texts]
        assert len(got.lines) == len(ref.lines)
        plt.close("all")


def test_phase_marker_and_argument():
    """Phase(0) and phase=0 evaluate the same harmonics as no phase; any
    other phase raises NotImplementedError, as in the JAX package."""
    rng = np.random.default_rng(3)
    c = coords.create_from_branching_types("ba")
    sph = {0: rng.uniform(0, np.pi, 5), 1: rng.uniform(0, 2 * np.pi, 5)}
    sph_t = {n: torch.tensor(v) for n, v in sph.items()}
    plain = harmonics.harmonics(c, sph_t, 4)
    ref = tonp(j_harmonics.harmonics(j_coords.create_from_branching_types("ba"), sph, 4,
                                     phase=j_harmonics.Phase(0)))
    for phase in (harmonics.Phase(0), 0):
        got = harmonics.harmonics(c, sph_t, 4, phase=phase)
        assert torch.equal(got, plain)
        assert _close(got.numpy(), ref)
    assert harmonics.Phase() == 0 and isinstance(harmonics.Phase(0), int)
    for bad in (1, -1):
        with pytest.raises(NotImplementedError):
            j_harmonics.Phase(bad)
        with pytest.raises(NotImplementedError):
            harmonics.Phase(bad)
        with pytest.raises(NotImplementedError):
            harmonics.harmonics(c, sph_t, 4, phase=bad)


@pytest.mark.parametrize("s", ["a", "ba", "bpa", "caa", "bba", "cbaa"])
def test_index_array_harmonics_matches_jax(s):
    got = harmonics.index_array_harmonics(coords.create_from_branching_types(s), 6)
    ref = j_harmonics.index_array_harmonics(j_coords.create_from_branching_types(s), 6)
    np.testing.assert_array_equal(got, ref)


RADIAL_R = np.array([[0.5, 1.5, 3.0], [0.7, 1.1, 2.2]])


@pytest.mark.parametrize("derivative", [False, True])
@pytest.mark.parametrize("kind", ["regular", "singular"])
@pytest.mark.parametrize("s", ["ba", "bba"])
def test_regular_singular_component_matches_jax(s, kind, derivative):
    """Per flat harmonic at radii [2, 3] x k = 1.3, n_end = 7 (d = 3, 4),
    against the JAX package's (committed: `jax_golden`)."""
    r = RADIAL_R
    got = harmonics.regular_singular_component(
        coords.create_from_branching_types(s), torch.tensor(r), 7, torch.tensor(1.3, **F64),
        type=kind, derivative=derivative).numpy()
    ref = _jax_golden.load("test_torch_surfaces")[f"radial {s} {kind} {derivative}"]
    assert got.shape == ref.shape == r.shape + (harmonics.basis(
        coords.create_from_branching_types(s), 7).num,)
    assert _close(got, ref)
    with pytest.raises(ValueError, match="invalid type"):
        harmonics.regular_singular_component(coords.create_from_branching_types(s),
                                             torch.tensor(r), 7, 1.3, type="bogus")


def test_orthonormal_jacobi_all_matches_jax():
    x = np.linspace(-1.0, 1.0, 9)
    for alpha, beta in ((0.0, 0.0), (0.5, -0.5), (2.0, 1.0)):
        got = special.orthonormal_jacobi_all(torch.tensor(x), 12, alpha, beta).numpy()
        ref = np.asarray(j_special.orthonormal_jacobi_all(x, 12, alpha, beta))
        assert got.shape == ref.shape == (9, 13)
        assert _close(got, ref)
    assert special.orthonormal_jacobi_all(torch.tensor([0, 1]), 3, 0.0, 0.0).dtype == torch.float64


POTENTIAL_KS = {"real-k": 1.3, "complex-k": 1.3 + 0.4j}


def _potential_args():
    """(n [8, 1], y_abs [3], x_abs [3]) of test_potential_coef_matches_jax."""
    return np.arange(8)[:, None], np.array([0.8, 1.0, 1.6]), np.array([2.0, 2.5, 3.0])


def jax_golden():
    """The JAX package's values that test_regular_singular_component_matches_jax
    and test_potential_coef_matches_jax read (their eager calls compile
    the spherical families op by op: minutes on a cold CPU)."""
    n, y_abs, x_abs = _potential_args()
    out = {}
    for s in ("ba", "bba"):
        for kind in ("regular", "singular"):
            for derivative in (False, True):
                out[f"radial {s} {kind} {derivative}"] = tonp(
                    j_harmonics.regular_singular_component(
                        j_coords.create_from_branching_types(s), RADIAL_R, 7, np.asarray(1.3),
                        type=kind, derivative=derivative))
    for d in (2, 3, 4):
        for kname, k in POTENTIAL_KS.items():
            kj = (C(np.asarray(k.real), np.asarray(k.imag)) if isinstance(k, complex)
                  else np.asarray(k))
            for der in ("S", "D"):
                for ff in ("solution", "harmonics"):
                    out[f"{d} {kname} {der} {ff}"] = tonp(j_layer.potential_coef(
                        n, d, kj, y_abs, x_abs, der, for_func=ff))
    return out


@pytest.mark.parametrize("k", list(POTENTIAL_KS.values()), ids=list(POTENTIAL_KS))
@pytest.mark.parametrize("d", [2, 3, 4])
def test_potential_coef_matches_jax(d, k):
    """Elementwise in (n, k, y_abs, x_abs): "S" / "D" x "solution" /
    "harmonics" against the JAX package's (committed: `jax_golden`); the
    argument errors as in the JAX package."""
    n, y_abs, x_abs = _potential_args()
    kname = "complex-k" if isinstance(k, complex) else "real-k"
    jax_values = _jax_golden.load("test_torch_surfaces")
    for der in ("S", "D"):
        for ff in ("solution", "harmonics"):
            got = potential_coef(torch.tensor(n), d, torch.tensor(np.asarray(k)),
                                 torch.tensor(y_abs), torch.tensor(x_abs), der,
                                 for_func=ff).numpy()
            ref = jax_values[f"{d} {kname} {der} {ff}"]
            assert got.shape == ref.shape == (8, 3)
            assert _close(got, ref), (der, ff)
    # the JAX package's messages (biem/_layer.py)
    for kw, match in ((dict(derivative="X"), "derivative must be 'S' or 'D'"),
                      (dict(for_func="harmonics"), "x_abs required"),
                      (dict(for_func="bogus"), "for_func must be")):
        with pytest.raises(ValueError, match=match):
            potential_coef(torch.tensor(n), d, k, torch.tensor(y_abs), **kw)


def test_btensorsolve_matches_jax():
    """A [2 | 3, 4 | 3, 4] block system and its [2 | 3, 4] right-hand side,
    one batch axis; and a real system with no batch axis."""
    rng = np.random.default_rng(5)
    m = rng.normal(size=(2, 3, 4, 3, 4)) + 1j * rng.normal(size=(2, 3, 4, 3, 4))
    m += 6.0 * np.eye(12).reshape(3, 4, 3, 4)
    b = rng.normal(size=(2, 3, 4)) + 1j * rng.normal(size=(2, 3, 4))
    got = utils.btensorsolve(torch.tensor(m), torch.tensor(b), num_batch_axes=1).numpy()
    ref = tonp(j_utils.btensorsolve(m, b, num_batch_axes=1))
    assert got.shape == ref.shape == (2, 3, 4)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    m2, b2 = m[0].real, b[0].real
    got2 = utils.btensorsolve(torch.tensor(m2), torch.tensor(b2)).numpy()
    assert np.allclose(np.einsum("ijkl,kl->ij", m2, got2), b2, rtol=0, atol=1e-12)


@pytest.mark.parametrize("axes", [(-2, -1), (0, 2), (2, 1)])
def test_shift_nth_row_n_steps_matches_jax(axes):
    a = np.random.default_rng(6).normal(size=(4, 3, 5))
    got = utils.shift_nth_row_n_steps(torch.tensor(a), *axes).numpy()
    ref = np.asarray(j_utils.shift_nth_row_n_steps(a, *axes))
    np.testing.assert_array_equal(got, ref)


def test_timed_records_into_the_sink():
    for mod in (utils, j_utils):
        sink = {}
        with mod.timed("block", sink):
            time.sleep(0.01)
        assert set(sink) == {"block"} and sink["block"] >= 0.01
        with mod.timed("no sink"):
            pass


@pytest.mark.parametrize("btype", ["ba", "bpbpa", "caa"])
def test_node_by_id_matches_jax(btype):
    """`SphericalCoordinates.node_by_id`: for every id the same node (kind,
    id, cartesian axes, sphere dimension) as the JAX package's, and KeyError
    for an id the tree lacks, as there."""
    c, jc = coords.create_from_branching_types(btype), j_coords.create_from_branching_types(btype)
    assert len(c.nodes) == len(jc.nodes)
    for node in jc.nodes:
        got, ref = c.node_by_id(node.nid), jc.node_by_id(node.nid)
        assert (got.kind, got.nid, tuple(got.axes), got.sdim) == (
            ref.kind, ref.nid, tuple(ref.axes), ref.sdim)
    for bad in (len(jc.nodes), -1):
        with pytest.raises(KeyError):
            jc.node_by_id(bad)
        with pytest.raises(KeyError):
            c.node_by_id(bad)
