"""parallel/ on torch.distributed against the JAX package's parallel/.

The port's ranks are spawned processes in one gloo group (CPU tensors),
meeting through a FileStore under the test's temporary directory (no
ports, so pytest-xdist workers do not race); each rank computes the
sharded sweep, points, dense, matrix-free and lattice solves
(tests/_torch_parallel_ranks.py) and writes them for the checks here.
The JAX side is the JAX package on the 8-device CPU mesh of
tests/conftest.py; its values are read from tests/golden/
test_torch_parallel.npz (`jax_golden`, `python
tools/torch_golden_from_jax.py --tests test_torch_parallel`: its sharded
compiles take minutes cold).

Tolerances: the JAX package's own parallel tests' (the sweep and the
points rtol 1e-9; the dense solve 1e-8 of the largest density entry; the
matrix-free solve rtol 1e-8 / atol 1e-10; the lattice 1e-8 relative to
the largest entry).  Every rank holds the same bits; each rank's operator
is at most 0.55 of the whole one on one device.
"""

import _jax_golden
import _torch_parallel_ranks as ranks
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu_torch.ops.dense import (
    _KD_ROWS,
    _dense_assemble_plain,
    _pair_order,
    _window_pairs,
    _window_tiles,
    dense_assemble,
)
from biem_helmholtz_sphere_tpu_torch.parallel import dryrun_multichip, make_mesh
from biem_helmholtz_sphere_tpu_torch.parallel._dryrun import spawn_ranks

WORLDS = (2, 4)


def jax_golden():
    """The JAX package's values: its sharded sweep and points on the 8-device
    CPU mesh, and its single-device references of the three solves."""
    import jax.numpy as jnp

    from biem_helmholtz_sphere_tpu import biem as j_biem
    from biem_helmholtz_sphere_tpu import plane_wave as j_plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
    from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
    from biem_helmholtz_sphere_tpu.parallel import make_mesh as j_mesh
    from biem_helmholtz_sphere_tpu.parallel import sharded_sweep as j_sweep
    from biem_helmholtz_sphere_tpu.parallel import sharded_uscat as j_uscat

    ba, a = j_tree("ba"), j_tree("a")
    x_dir = np.array([1.0, 0.0, 0.0])
    out = {"sweep": tonp(j_sweep(ba, centers=ranks.PAIR, radii=np.ones(2), ks=ranks.KS,
                                 n_end=4, direction=x_dir,
                                 mesh=j_mesh(n_devices=8, axis_names=("sweep",))))}
    uin, _ = j_plane_wave(k=jnp.asarray(ranks.KS[3]), direction=jnp.asarray(x_dir))
    calc = j_biem(ba, centers=ranks.PAIR, radii=np.ones(2), k=jnp.asarray(ranks.KS[3]),
                  n_end=4, uin=uin)
    out["uscat"] = tonp(j_uscat(calc, ranks.POINTS,
                                mesh=j_mesh(n_devices=8, axis_names=("points",))))

    def density(c, centers, n_end, direction, **kw):
        uin, _ = j_plane_wave(k=np.asarray(1.0), direction=jnp.asarray(direction))
        return tonp(j_biem(c, centers=centers, radii=np.ones(len(centers)),
                           k=np.asarray(1.0), n_end=n_end, uin=uin, **kw).density)

    out["dense"] = density(ba, ranks.PAIR, 4, x_dir, solver="gmres")
    out["matfree"] = density(a, ranks.lattice(2, 2), 8, x_dir[:2])
    out["lattice"] = density(a, ranks.lattice(4, 2), ranks.N_END_LATTICE, x_dir[:2],
                             solver="matfree")
    return out


@pytest.fixture(scope="module")
def golden():
    return _jax_golden.load("test_torch_parallel")


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ran(request, tmp_path_factory):
    """Every rank's results of one spawned gloo group."""
    world = request.param
    out = tmp_path_factory.mktemp(f"ranks{world}")
    spawn_ranks(ranks.run, world, str(out), "cpu", str(out))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def test_sharded_sweep_and_uscat_match_jax(ran, golden):
    np.testing.assert_allclose(ran[0]["sweep"], golden["sweep"], rtol=1e-9)
    np.testing.assert_allclose(ran[0]["uscat"], golden["uscat"], rtol=1e-9)


def test_dense_sharded_solve_matches_jax_gmres(ran, golden):
    """32 rows over 2 and 4 ranks: with 4, two ranks share each ball."""
    ref = golden["dense"]
    np.testing.assert_allclose(ran[0]["dense"], ref, rtol=0, atol=1e-8 * np.abs(ref).max())
    assert "all_gather_into_tensor" in ran[0]["dense collectives"]


def test_matfree_sharded_solve_matches_jax_dense(ran, golden):
    np.testing.assert_allclose(ran[0]["matfree"], golden["matfree"], rtol=1e-8, atol=1e-10)
    assert "all_reduce" in ran[0]["matfree collectives"]


def test_lattice_sharded_solve_matches_jax_matfree(ran, golden):
    ref = golden["lattice"]
    assert np.abs(ran[0]["lattice"] - ref).max() / np.abs(ref).max() < 1e-8
    assert set(ran[0]["lattice collectives"]) == {"all_gather_into_tensor",
                                                  "all_to_all_single"}


def test_every_rank_holds_rank0s_bits(ran):
    for r, res in enumerate(ran[1:], 1):
        for name in ("sweep", "uscat", "dense", "matfree", "lattice"):
            assert res[name].tobytes() == ran[0][name].tobytes(), (r, name)


def test_per_rank_operator_bytes(ran):
    """Each rank stores at most 0.55 of the whole matrix, offset table or
    lattice kernel (exactly 1 / world at these shapes)."""
    world = len(ran)
    for res in ran:
        for name in ("dense", "matfree", "lattice"):
            mine, whole = res[f"{name} bytes"]
            assert 0 < mine <= 0.55 * whole, (name, mine, whole)
            assert mine == whole // world, (name, mine, whole)


def test_mesh_and_dryrun_need_cuda_unless_cpu_is_asked(ran):
    assert all(bool(res["mesh needs cuda"]) for res in ran)
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA cards"):
        dryrun_multichip(2)


def test_dryrun_multichip_on_cpu_ranks():
    dryrun_multichip(2, device="cpu")


_WINDOWS = ((0, 32), (8, 16), (5, 27), (31, 32), (16, 17))


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_kd_row_window_equals_rows_of_the_whole_matrix(dtype):
    """KD's plain version (its CPU path and its oracle on the card) gives a
    row window equal entry for entry to those rows of the whole matrix,
    also where the window cuts a ball and with a pair map per k."""
    rng = np.random.default_rng(14)
    n_k, n_b, h, n_off = 2, 2, 16, 3

    def rc(*shape):
        return torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                               dtype=dtype)

    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    sgn = torch.as_tensor((-1.0) ** np.arange(h), dtype=rdt)
    pids = (torch.tensor([[0, 1], [1, 0]]), torch.tensor([[[0, 2], [2, 0]], [[0, 1], [1, 0]]]))
    for pid in pids:
        args = (rc(n_k, n_off, h, h), pid, rc(n_k, n_b, h), rc(n_k, n_b, h), sgn,
                rc(n_k, n_b, h))
        whole = dense_assemble(*args).reshape(n_k, n_b * h, n_b * h)
        assert torch.equal(whole, _dense_assemble_plain(*args, False).reshape(whole.shape))
        for r0, r1 in _WINDOWS:
            got = dense_assemble(*args, rows=(r0, r1))
            assert got.shape == (n_k, r1 - r0, n_b, h)
            assert torch.equal(got.reshape(n_k, r1 - r0, -1), whole[:, r0:r1]), (r0, r1)
    with pytest.raises(ValueError, match="not a window"):
        dense_assemble(*args, pair_major=True, rows=(0, 16))


@pytest.mark.parametrize("n_b, h", [(2, 16), (3, 25), (5, 7)])
def test_kd_row_window_grid_writes_each_row_once(n_b, h):
    """The CUDA kernel's CTA plan for a row window, emulated: the pairs of
    the balls that meet the window, tile = lo / kRows + blockIdx.y clipped
    to the ball's rows inside the window, write every (row, b') of the
    window exactly once and nothing outside it."""
    pid = torch.zeros((n_b, n_b), dtype=torch.long)
    n = n_b * h
    for r0, r1 in ((0, n), (1, n - 1), (h - 3, h + 2), (n // 3, 2 * n // 3), (n - 1, n)):
        pairs = _window_pairs(_pair_order(pid), h, r0, r1).numpy()
        hits = np.zeros((n, n_b), np.int64)
        for b, bp, _ in pairs:
            lo, hi = max(r0 - b * h, 0), min(r1 - b * h, h)
            for y in range(_window_tiles(h, r0, r1, _KD_ROWS)):
                tile = lo // _KD_ROWS + y
                h0, h1 = max(lo, tile * _KD_ROWS), min(hi, (tile + 1) * _KD_ROWS)
                for hh in range(h0, h1):
                    hits[b * h + hh, bp] += 1
        assert (hits[r0:r1] == 1).all() and hits[:r0].sum() == 0 and hits[r1:].sum() == 0
