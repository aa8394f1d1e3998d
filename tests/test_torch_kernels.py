"""The port's kernel modules against the JAX stages they replace.

On the CPU every wrapper runs its plain PyTorch version, so these tests
hold the plain versions to the JAX package (float64, same numpy inputs):
KA fused_ba_eval vs _fused_ba_dot_blocked with the _h_clamped radial
table; KB block_diag_cmm vs the three einsums of the factored matvec; KC
lane_gather/lane_scatter vs the one-hot routing; and the whole matvec.
The CUDA kernels themselves are held to the plain versions by the
`requires_cuda` tests of test_torch_cuda.py (skipped without a card) and
by chip_smoke.py.

Tolerances: float64, different summation order (dense einsum vs
blocks, one-hot matmul vs gather/index_add, scan vs loop): 1e-12 of the
largest entry.  The JAX package's whole factored matvec is committed in
tests/golden/test_torch_kernels.npz (`jax_golden`, `python
tools/torch_golden_from_jax.py --tests`).
"""

from dataclasses import replace

import _jax_golden
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu.biem._core import (
    _check_biem_inputs as j_check_inputs,
    _matfree_operator as j_matfree_operator,
    _pair_routing as j_pair_routing,
)
from biem_helmholtz_sphere_tpu.biem._eval import _h_clamped as j_h_clamped
from biem_helmholtz_sphere_tpu.biem._eval_fused import (
    _fused_ba_dot_blocked as j_fused_ba_dot_blocked,
)
from biem_helmholtz_sphere_tpu.coords import create_from_branching_types as j_tree
from biem_helmholtz_sphere_tpu.coords import from_cartesian as j_from_cartesian
from biem_helmholtz_sphere_tpu.ops import cplx
from biem_helmholtz_sphere_tpu.ops.cplx import C
from biem_helmholtz_sphere_tpu.ops.cplx import to_numpy as tonp
from biem_helmholtz_sphere_tpu_torch.biem._core import (
    _factored_operator,
    _pair_routing,
)
from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import fused_ba_eval, regroup
from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
from biem_helmholtz_sphere_tpu_torch.harmonics import basis
from biem_helmholtz_sphere_tpu_torch.harmonics._index import harm_n_ndim
from biem_helmholtz_sphere_tpu_torch.ops import kernels
from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
    LaneSegments,
    _block_diag_cmm_plain,
    block_diag_cmm,
    pack,
    unpack,
)
from biem_helmholtz_sphere_tpu_torch.ops.lane_route import (
    _lane_gather_plain,
    lane_gather,
    lane_scatter,
    make_route,
)
from biem_helmholtz_sphere_tpu_torch.special._family import spherical_jh
from biem_helmholtz_sphere_tpu_torch.translation import coaxial_scaled, rotation_matrix
from biem_helmholtz_sphere_tpu_torch.translation._scaled import _child_state_blocks, coax_fold


_HYPERCUBE = np.stack(np.meshgrid(*([[-2.0, 2.0]] * 4), indexing="ij"), axis=-1).reshape(-1, 4)


def _lattice(n_side=4, spacing=4.0):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    return np.stack([xx.ravel(), yy.ravel(), np.zeros(n_side * n_side)], axis=1)


def _randc(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _close(got, ref, rel=1e-12):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _weights(rng, n_balls, n_end):
    """Random densities decaying with degree like a converged solution."""
    ell = basis(create_from_branching_types("ba"), n_end).n_root
    return _randc(rng, (n_balls, n_end * n_end)) * np.exp(-0.7 * ell)


def _points_outside(rng, centers, n, scale=6.0):
    x = rng.normal(size=(3, 4 * n)) * scale
    r = np.linalg.norm(x[:, :, None] - centers.T[:, None, :], axis=0)
    return x[:, (r > 1.05).all(axis=1)][:, :n]


def test_fused_ba_eval_plain_matches_jax_near_field():
    n_end, k = 9, 2.3
    rng = np.random.default_rng(21)
    centers = _lattice(2, 4.0)
    w = _weights(rng, len(centers), n_end)
    x = _points_outside(rng, centers, 40)
    c_j = j_tree("ba")
    sph = j_from_cartesian(c_j, x[:, :, None] - centers.T[:, None, :])
    h = j_h_clamped(3, n_end, k * sph["r"])
    u_j = tonp(j_fused_ba_dot_blocked(c_j, n_end, C.of(w), sph[0], sph[1], rad=h)).sum(-1)
    c_t = create_from_branching_types("ba")
    u_t = fused_ba_eval(
        torch.as_tensor(x)[:, None, :], torch.as_tensor(centers),
        torch.tensor([k], dtype=torch.float64), regroup(c_t, n_end, torch.as_tensor(w)[None]),
    )
    _close(u_t[:, 0].numpy(), u_j)


def test_fused_ba_eval_plain_matches_jax_far_field():
    n_end = 7
    rng = np.random.default_rng(22)
    centers = _lattice(2, 4.0)
    w = _weights(rng, len(centers), n_end)
    x = rng.normal(size=(3, 25))
    x /= np.linalg.norm(x, axis=0)
    c_j = j_tree("ba")
    sph = j_from_cartesian(c_j, x)
    u_j = tonp(j_fused_ba_dot_blocked(
        c_j, n_end, C.of(w), sph[0][:, None], sph[1][:, None]))  # [P, B]
    c_t = create_from_branching_types("ba")
    u_t = fused_ba_eval(
        torch.as_tensor(x)[:, None, :], torch.as_tensor(centers),
        torch.tensor([1.0], dtype=torch.float64),
        regroup(c_t, n_end, torch.as_tensor(w)[None]), far=True, per_ball=True,
    )
    _close(u_t[:, 0].numpy(), u_j)


def test_fused_ba_eval_plain_matches_jax_at_one_point_four_k():
    """The shape of uscat(0) for a k-block (P = 1, K = 4), which takes the
    kernel's few-point mode on the card: each k against the JAX package."""
    n_end, ks = 8, np.array([1.3, 1.7, 2.1, 2.6])
    rng = np.random.default_rng(30)
    centers = _lattice(2, 4.0)
    w = np.stack([_weights(rng, len(centers), n_end) for _ in ks])
    x = np.zeros((3, 1))
    c_j = j_tree("ba")
    sph = j_from_cartesian(c_j, x[:, :, None] - centers.T[:, None, :])
    u_j = np.stack([
        tonp(j_fused_ba_dot_blocked(c_j, n_end, C.of(w[i]), sph[0], sph[1],
                                    rad=j_h_clamped(3, n_end, k * sph["r"]))).sum(-1)
        for i, k in enumerate(ks)
    ], axis=-1)  # [P, K]
    u_t = fused_ba_eval(
        torch.as_tensor(x)[:, None, :], torch.as_tensor(centers), torch.as_tensor(ks),
        regroup(create_from_branching_types("ba"), n_end, torch.as_tensor(w)),
    )
    assert u_t.shape == (1, len(ks))
    _close(u_t.numpy(), u_j)


def test_pair_routing_counts_on_the_bench_lattice():
    """24 distinct offsets on the 4x4 lattice fall on 9 radii; padded to
    g_max = 4 slots per radius they make 36 slots x 2 * 12 = 864 padded
    lanes, of which the 240 that route a pair (120 pairs and their
    mirrors) are kept, sorted by slot."""
    centers = _lattice()
    rt = _pair_routing(centers)
    assert (len(rt.uniq), len(rt.uniq_r), rt.g_max, rt.p_max) == (36, 9, 4, 12)
    assert len(rt.src) == len(rt.dst) == len(rt.dn) == len(rt.lane) == 240
    assert (rt.slot_ptr[0], rt.slot_ptr[-1], len(rt.slot_ptr)) == (0, 240, 37)
    assert (np.diff(rt.slot_ptr) > 0).sum() == 24  # slots that hold an offset
    np.testing.assert_array_equal(rt.rad_ptr, rt.slot_ptr[::4])
    uniq, gth, sct, p_max, uniq_r, g_max = j_pair_routing(centers, radius_slots=True)
    assert gth.shape[0] == 864 and p_max == rt.p_max and g_max == rt.g_max
    np.testing.assert_array_equal(rt.uniq, uniq)
    np.testing.assert_array_equal(rt.uniq_r, uniq_r)
    # the compacted index tables route exactly like the one-hot matrices
    gth_t = np.zeros_like(gth)
    sct_t = np.zeros_like(sct)
    gth_t[rt.lane, rt.src] = 1.0
    sct_t[rt.dst, rt.lane] = 1.0
    np.testing.assert_array_equal(gth_t, gth)
    np.testing.assert_array_equal(sct_t, sct)
    np.testing.assert_array_equal(rt.dn, rt.lane % (2 * p_max) >= p_max)


def test_lane_route_plain_matches_jax_one_hot():
    n_end, n_k = 4, 2
    rng = np.random.default_rng(23)
    centers = _lattice()
    nb, h = len(centers), n_end * n_end
    _, gth, sct, p_max, _, _ = j_pair_routing(centers, radius_slots=True)
    rt = _pair_routing(centers)
    route = make_route(rt.src, rt.dst, rt.dn, nb, torch.device("cpu"))
    pm = (-1.0) ** (basis(create_from_branching_types("ba"), n_end).n_root % 2)
    x, blc, diag, reg = (_randc(rng, (n_k, nb, h)) for _ in range(4))
    y = _randc(rng, (n_k, len(rt.src), h))
    z = blc * x
    lanes_j = np.einsum("pq,kqh->kph", gth, np.concatenate([z, z * pm], axis=1))
    t = torch.as_tensor
    lanes_t = lane_gather(t(x), t(blc), t(pm), route)
    _close(lanes_t.numpy(), lanes_j[:, rt.lane])
    # the padded lanes the JAX package routes hold zeros off the used lanes
    y_all = np.zeros((n_k, gth.shape[0], h), complex)
    y_all[:, rt.lane] = y
    y_all = y_all.reshape(n_k, -1, 2 * p_max, h)
    y_all[:, :, p_max:] *= pm
    out_j = diag * x + reg * np.einsum("bp,kph->kbh", sct, y_all.reshape(n_k, -1, h))
    _close(lane_scatter(t(y), t(x), t(diag), t(reg), t(pm), route).numpy(), out_j)


def _segments(rng, n_mat, lanes_per_mat):
    """Random compacted lanes: each matrix keeps some of its padded lanes
    (one keeps none).  Returns (LaneSegments, padded index of each lane)."""
    keep = rng.random((n_mat, lanes_per_mat)) < 0.6
    keep[0] = False
    padded = np.nonzero(keep.ravel())[0]
    ptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
    return LaneSegments(tuple(int(v) for v in ptr)), padded


@pytest.mark.parametrize("which", ["D^H", "X", "D"])
def test_block_diag_cmm_plain_matches_jax_einsum(which):
    """The three products of the factored matvec, as JAX writes them on
    padded lanes, held to the port's compacted lanes (the used lanes)."""
    n_end, n_k, n_slots, n_rad, lanes = 5, 2, 6, 3, 4
    rng = np.random.default_rng(24)
    c = create_from_branching_types("ba")
    h = n_end * n_end
    if which == "X":
        sizes, perm = _child_state_blocks(c, n_end)
        stack, x_shape = (n_k, n_rad), (n_k, n_rad, lanes * n_slots // n_rad, h)
    else:
        sizes, perm = 2 * np.arange(n_end) + 1, None
        stack, x_shape = (n_slots,), (n_k, n_slots, lanes, h)
    blocks = pack(torch.zeros(stack + (h, h), dtype=torch.complex128), sizes, perm)
    blocks = replace(blocks, vals=torch.as_tensor(_randc(rng, blocks.vals.shape)))
    dense = unpack(blocks).numpy()
    seg, padded = _segments(rng, x_shape[1], x_shape[2])
    w = np.zeros(x_shape, complex).reshape(n_k, -1, h)
    w[:, padded] = _randc(rng, (n_k, len(padded), h))
    w = w.reshape(x_shape)
    if which == "D^H":
        y_j = cplx.einsum("ogh,...opg->...oph", C.of(dense).conj(), C.of(w))
    elif which == "X":
        y_j = cplx.einsum("...rhg,...rpg->...rph", C.of(dense), C.of(w))
    else:
        y_j = cplx.einsum("ohg,...opg->...oph", C.of(dense), C.of(w))
    x_c = torch.as_tensor(w.reshape(n_k, -1, h)[:, padded])
    y_t = block_diag_cmm(blocks, x_c, seg, adjoint=which == "D^H")
    _close(y_t.numpy(), tonp(y_j).reshape(n_k, -1, h)[:, padded])


def test_packing_is_exact_for_the_operator_tables():
    """D and the coaxial factor X vanish exactly off their blocks, so the
    packed form is the same function as the dense einsum."""
    c = create_from_branching_types("ba")
    n_end = 6
    rng = np.random.default_rng(25)
    t_hat = torch.as_tensor(rng.normal(size=(5, 3)))
    d = rotation_matrix(c, t_hat / t_hat.norm(dim=-1, keepdim=True), n_end)
    x, _ = coaxial_scaled(c, torch.tensor([4.0, 8.0], dtype=torch.float64), n_end,
                          torch.tensor([[1.3], [2.2]], dtype=torch.float64))
    for dense, (sizes, perm) in ((d, (2 * np.arange(n_end) + 1, None)),
                                 (x, _child_state_blocks(c, n_end))):
        bd = pack(dense, sizes, perm)
        assert torch.equal(unpack(bd), dense)
        n_mat = dense.shape[-3]
        seg = LaneSegments(tuple(range(0, 3 * n_mat + 1, 3)))
        n_k = dense.shape[0] if dense.ndim == 4 else 2
        lanes = torch.as_tensor(_randc(rng, (n_k, 3 * n_mat, dense.shape[-1])))
        assert torch.equal(block_diag_cmm(bd, lanes, seg),
                           _block_diag_cmm_plain(dense, lanes, seg, False))


MATVEC_KS = np.array([1.1, 1.9])  # test_factored_matvec_matches_jax, n_end = 4


def _matvec_x():
    return _randc(np.random.default_rng(26), (len(MATVEC_KS), len(_lattice()) * 16))


def jax_golden():
    """The JAX package's factored operator (diag, one matvec) that
    test_factored_matvec_matches_jax reads: a minute of compile on a cold
    CPU."""
    centers = _lattice()
    nb, n_k = len(centers), len(MATVEC_KS)
    c_j = j_tree("ba")
    _, rad, kc, eta_c, al, be = j_check_inputs(
        c_j, np.broadcast_to(centers, (n_k, nb, 3)), np.ones((n_k, nb)), MATVEC_KS, None, 1.0,
        0.0
    )
    mv_j, diag_j = j_matfree_operator(c_j, 4, centers, rad, kc, eta_c, al, be, None, stable=True)
    return {"factored diag": tonp(diag_j), "factored matvec": tonp(mv_j(C.of(_matvec_x())))}


def test_factored_matvec_matches_jax():
    """One factored matvec and the diagonal against the JAX package's
    (committed: `jax_golden`)."""
    n_end, n_k = 4, len(MATVEC_KS)
    centers = _lattice()
    nb = len(centers)
    ks = MATVEC_KS
    ref = _jax_golden.load("test_torch_kernels")
    diag_j, y_j = ref["factored diag"], ref["factored matvec"]
    x = _matvec_x()
    f64 = dict(dtype=torch.float64)
    mv_t, diag_t = _factored_operator(
        create_from_branching_types("ba"), n_end, centers, torch.ones(n_k, nb, **f64),
        torch.as_tensor(ks), torch.ones(n_k, **f64),
        torch.ones(n_k, nb, dtype=torch.complex128),
        torch.zeros(n_k, nb, dtype=torch.complex128),
    )
    _close(diag_t.numpy(), diag_j)
    _close(mv_t(torch.as_tensor(x)).numpy(), y_j)


def test_cpu_wrappers_never_touch_the_kernel_library(monkeypatch):
    """On CPU tensors the wrappers take their plain versions, build and
    load nothing, and count no launch."""
    def no_library():
        raise AssertionError("the kernel library was requested for CPU tensors")

    monkeypatch.setattr(kernels, "library", no_library)
    wrappers = (fused_ba_eval, block_diag_cmm, lane_gather, lane_scatter, spherical_jh,
                coax_fold)
    counts = [w.launches for w in wrappers] + [fused_ba_eval.few_launches]
    test_lane_route_plain_matches_jax_one_hot()
    test_block_diag_cmm_plain_matches_jax_einsum("X")
    test_fused_ba_eval_plain_matches_jax_far_field()
    test_factored_matvec_matches_jax()  # K5 (radial rows, coax bands) and K2
    test_fused_ba_eval_plain_matches_jax_at_one_point_four_k()
    assert counts == [w.launches for w in wrappers] + [fused_ba_eval.few_launches]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: without a CUDA compiler the build raises."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    assert not (tmp_path / "kernels").exists()


_GEOMETRIES = {
    "bench": _lattice(),
    "2-sphere": np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]]),
    "3-sphere": np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [0.0, 4.0, 1.0]]),
}
# KB's work lists: (tree, n_end, centers); the 3D geometries at n_end=32,
# the 4D hypercube {-2, 2}^4 (degree blocks up to 256 and 400: row panels)
# and the 5D pair at n_end=8 (blocks up to 204)
_WORK_LISTS = {
    **{name: ("ba", 32, centers) for name, centers in _GEOMETRIES.items()},
    "4d-hypercube-16": ("bba", 16, _HYPERCUBE),
    "4d-hypercube-20": ("bba", 20, _HYPERCUBE),
    "5d-pair-8": ("bbba", 8, np.array([[0.0, 2.0, 0.0, 0.0, 0.0], [0.0, -2.0, 0.0, 0.0, 0.0]])),
}


def _work_list_cases(geometry):
    """(D's and X's (block sizes, lane segments, per_k)) of a geometry."""
    tree, n_end, centers = _WORK_LISTS[geometry]
    c = create_from_branching_types(tree)
    rt = _pair_routing(centers)
    cs_sizes, _ = _child_state_blocks(c, n_end)
    d_sizes = [harm_n_ndim(n, c.c_ndim) for n in range(n_end)]
    return [(tuple(int(v) for v in sizes), tuple(int(v) for v in seg), per_k)
            for sizes, seg, per_k in ((d_sizes, rt.slot_ptr, False),
                                      (cs_sizes, rt.rad_ptr, True))]


# KB's work lists at the 3D bench (4 k, the 240 compacted lanes; D over
# its 36 slots, X over its 9 radii) as the parent of the row-panel change
# built them: (items, elements per buffer, sha256 of the int32 items).
_BENCH_WORK_LISTS = {
    ("D", 8): (442, 7168, "2bf51a9cb3f7dfe9daa417c8018250959ff00ba0ad154efe5f424e2c02195995"),
    ("D", 16): (442, 7184, "dba368733476b15887ef98f3025da536e89633e2802bb9bcdc5622c0c3b6f4c3"),
    ("X", 8): (368, 7160, "b6667f101d0763daab85950e9fc9e000eac9f0d18666a9c0755fd51f3fb0c2d4"),
    ("X", 16): (652, 3584, "66ad614764bed81d43aa8c37aa61824549dd7256873bd30793cb40850ba0d0b3"),
}


def test_compacted_route_matches_the_padded_route():
    """KC gather -> KB D^H, X, D -> KC scatter on the 240 compacted lanes of
    the bench lattice equals the padded route (864 lanes, 36 slots, dense
    matrices, as PR 1's port and the JAX package lay it out), f64."""
    n_end, n_k = 4, 2
    rng = np.random.default_rng(29)
    c = create_from_branching_types("ba")
    centers = _lattice()
    nb, h = len(centers), n_end * n_end
    rt = _pair_routing(centers)
    n_slots, n_rad, lps = len(rt.uniq), len(rt.uniq_r), 2 * rt.p_max
    d_bd = pack(torch.zeros((n_slots, h, h), dtype=torch.complex128), 2 * np.arange(n_end) + 1)
    d_bd = replace(d_bd, vals=torch.as_tensor(_randc(rng, d_bd.vals.shape)))
    x_bd = pack(torch.zeros((n_k, n_rad, h, h), dtype=torch.complex128),
                *_child_state_blocks(c, n_end))
    x_bd = replace(x_bd, vals=torch.as_tensor(_randc(rng, x_bd.vals.shape)))
    pm = torch.as_tensor((-1.0) ** (basis(c, n_end).n_root % 2))
    x, blc, diag, reg = (torch.as_tensor(_randc(rng, (n_k, nb, h))) for _ in range(4))
    route = make_route(rt.src, rt.dst, rt.dn, nb, torch.device("cpu"))
    lanes = lane_gather(x, blc, pm, route)
    w = block_diag_cmm(d_bd, lanes, LaneSegments(tuple(rt.slot_ptr.tolist())), adjoint=True)
    v = block_diag_cmm(x_bd, w, LaneSegments(tuple(rt.rad_ptr.tolist())))
    y = block_diag_cmm(d_bd, v, LaneSegments(tuple(rt.slot_ptr.tolist())))
    out = lane_scatter(y, x, diag, reg, pm, route)

    # the padded route: every slot's 2 p_max lanes, zeros on unused lanes
    d, xm = unpack(d_bd).numpy(), unpack(x_bd).numpy()
    z = (blc * x).numpy()
    zs = np.concatenate([z, z * pm.numpy()], axis=1)
    lanes_p = np.zeros((n_k, n_slots * lps, h), complex)
    lanes_p[:, rt.lane] = zs[:, rt.src]
    lanes_p = lanes_p.reshape(n_k, n_slots, lps, h)
    np.testing.assert_array_equal(lanes_p.reshape(n_k, -1, h)[:, rt.lane], lanes.numpy())
    w_p = np.einsum("ogh,kopg->koph", d.conj(), lanes_p)
    v_p = np.einsum("krhg,krpg->krph", xm, w_p.reshape(n_k, n_rad, -1, h))
    y_p = np.einsum("ohg,kopg->koph", d, v_p.reshape(n_k, n_slots, lps, h)).reshape(n_k, -1, h)
    for got, ref in ((w, w_p), (v, v_p), (y, y_p)):
        ref = ref.reshape(n_k, -1, h)
        _close(got.numpy(), ref[:, rt.lane])
        unused = np.setdiff1d(np.arange(ref.shape[1]), rt.lane)
        assert np.abs(ref[:, unused]).max() == 0.0  # padding carried nothing
    y_mir = y_p.copy().reshape(n_k, n_slots, lps, h)
    y_mir[:, :, rt.p_max:] *= pm.numpy()
    cpl = np.zeros((n_k, nb, h), complex)
    for i, l in enumerate(rt.lane):
        cpl[:, rt.dst[i]] += y_mir.reshape(n_k, -1, h)[:, l]
    _close(out.numpy(), (diag * x).numpy() + reg.numpy() * cpl)


@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES))
def test_make_route_by_source_csr_lists_every_lane_once(geometry):
    """The KC gather's by-source CSR (src_ptr, src_lane): every lane is
    listed exactly once, under its own source row of [z; z*pm], and each
    source's lanes ascend."""
    centers = _GEOMETRIES[geometry]
    nb = len(centers)
    rt = _pair_routing(centers)
    route = make_route(rt.src, rt.dst, rt.dn, nb, torch.device("cpu"))
    ptr, lanes = route.src_ptr.numpy(), route.src_lane.numpy()
    assert ptr.shape == (2 * nb + 1,) and (ptr[0], ptr[-1]) == (0, len(rt.src))
    assert (np.diff(ptr) >= 0).all()
    np.testing.assert_array_equal(np.sort(lanes), np.arange(len(rt.src)))
    for s in range(2 * nb):
        own = lanes[ptr[s] : ptr[s + 1]]
        np.testing.assert_array_equal(own, np.nonzero(rt.src == s)[0])


def _gather_by_source(x, blc, pm, route):
    """The gather as the kernel walks it: each source row once, written to
    every lane of its CSR entry."""
    z = blc * x
    n_b = x.shape[1]
    lanes = torch.full((x.shape[0], route.src_lane.shape[0], x.shape[2]), complex("nan"),
                       dtype=x.dtype)
    ptr = route.src_ptr.tolist()
    for s in range(2 * n_b):
        row = z[:, s % n_b] * (pm if s >= n_b else 1.0)
        for q in range(ptr[s], ptr[s + 1]):
            lanes[:, int(route.src_lane[q])] = row
    return lanes


@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES) + ["empty-and-crowded"])
def test_plain_gather_by_source_csr_matches_the_plain_gather(geometry):
    """A gather driven by make_route's by-source CSR equals
    _lane_gather_plain, bit for bit; also on a routing where one source
    row has no lane and one has many, at an odd H (n_end = 5)."""
    n_end, n_k = 5, 2
    rng = np.random.default_rng(31)
    if geometry == "empty-and-crowded":
        nb = 3
        src = np.array([4, 0, 4, 4, 2, 4, 0, 5, 4, 3, 4])  # row 1 has no lane
        dst = rng.integers(0, nb, size=len(src))
        dn = src >= nb
    else:
        centers = _GEOMETRIES[geometry]
        nb = len(centers)
        rt = _pair_routing(centers)
        src, dst, dn = rt.src, rt.dst, rt.dn
    route = make_route(src, dst, dn, nb, torch.device("cpu"))
    h = n_end * n_end
    pm = torch.as_tensor((-1.0) ** (basis(create_from_branching_types("ba"), n_end).n_root % 2))
    x, blc = (torch.as_tensor(_randc(rng, (n_k, nb, h))) for _ in range(2))
    got = _gather_by_source(x, blc, pm, route)
    assert torch.equal(got, _lane_gather_plain(x, blc, pm, route))
