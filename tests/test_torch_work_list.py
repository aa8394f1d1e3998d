"""KB's host work list: coverage of every block and lane, and the 3D bench's
lists pinned by digest (split from test_torch_kernels.py so the test
workers share the kernel modules' tests)."""

import hashlib
import numpy as np
import pytest
import torch

from biem_helmholtz_sphere_tpu_torch.ops.block_diag import ITEM_FIELDS, _plan, item_stages

from test_torch_kernels import (  # noqa: F401 (fixtures)
    _BENCH_WORK_LISTS,
    _WORK_LISTS,
    _work_list_cases,
)


@pytest.mark.parametrize("elem_bytes", [8, 16])
@pytest.mark.parametrize("geometry", sorted(_WORK_LISTS))
def test_work_list_covers_every_block_and_lane_once(geometry, elem_bytes):
    """KB's host-built work list, for D (shared by the k's, slot segments)
    and X (one matrix per (k, radius), radius segments): every (matrix,
    block, row, k, lane) that a product needs is in exactly one item,
    nothing else is, every item fits its staging buffer (row panels
    column panel by column panel), an item of several column panels has
    at most one 4 x 2 tile per thread, and the list runs largest first.
    Rows are counted by the 4-row tiles that row panels start on."""
    n_k = 4
    for sizes, seg, per_k in _work_list_cases(geometry):
        n_mat = len(seg) - 1
        g = np.asarray(sizes)
        items_t, n_items, buf, paneled = _plan(sizes, seg, n_k, per_k, elem_bytes,
                                               torch.device("cpu"))
        items = items_t.numpy()
        assert items.shape == (n_items, ITEM_FIELDS) and 2 * buf * elem_bytes <= 232448
        assert buf % 4 == 0
        foot, panels = item_stages(items, sizes, buf)
        assert (foot <= buf).all()
        mat_, _, _, _, _, b0_, b1_, q0_, q1_, r0_, r1_ = items.T.astype(np.int64)
        rows = np.minimum(r1_, g[b0_]) - r0_
        tiles = -(-rows // 4) * -(-(q1_ - q0_) // 2)
        assert ((panels == 1) | ((b1_ - b0_ == 1) & (tiles <= 256))).all()
        assert paneled == bool((panels > 1).any() or (rows < g[b0_]).any())
        # D's degree blocks need row panels in 4D and 5D; X's child-state
        # blocks (at most n_end) never do
        assert paneled == (not per_k and geometry[:2] in ("4d", "5d"))
        n_rt = -(-int(g.max()) // 4)
        for mat in range((n_k if per_k else 1) * n_mat):
            m = mat % n_mat
            nl_m = seg[m + 1] - seg[m]
            cover = np.zeros((len(g), n_rt, n_k, max(nl_m, 1)), int)
            for _, k0, nk, lane0, nl, b0, b1, q0, q1, r0, r1 in items[mat_ == mat]:
                assert (lane0, nl) == (seg[m], nl_m) and 0 <= q0 < q1 <= nk * nl
                assert (k0, nk) == ((mat // n_mat, 1) if per_k else (0, n_k))
                assert r0 % 4 == 0
                for b in range(b0, b1):
                    assert 0 <= r0 < min(r1, g[b])
                    rt0, rt1 = r0 // 4, -(-min(r1, g[b]) // 4)
                    for q in range(q0, q1):
                        cover[b, rt0:rt1, k0 + q // nl, q % nl] += 1
            want = np.zeros_like(cover)
            if nl_m:
                for b in range(len(g)):
                    ks = slice(mat // n_mat, mat // n_mat + 1) if per_k else slice(None)
                    want[b, : -(-g[b] // 4), ks, :] = 1
            np.testing.assert_array_equal(cover, want)
        work = [int((g[b0:b1] * (np.minimum(r1, g[b0:b1]) - r0)).sum()) * (q1 - q0)
                for b0, b1, q0, q1, r0, r1 in items[:, 5:].astype(np.int64)]
        assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("matrix,elem_bytes", sorted(_BENCH_WORK_LISTS))
def test_work_list_at_the_3d_bench_is_unchanged(matrix, elem_bytes):
    """Row panels leave the 3D bench's work lists as they were: the same
    items (the first nine fields, pinned by digest), each over the whole
    rows of its blocks, the same buffer, no panels."""
    (d_case, x_case) = _work_list_cases("bench")
    sizes, seg, per_k = d_case if matrix == "D" else x_case
    items_t, n_items, buf, paneled = _plan(sizes, seg, 4, per_k, elem_bytes,
                                           torch.device("cpu"))
    items = items_t.numpy()
    digest = hashlib.sha256(np.ascontiguousarray(items[:, :9], dtype=np.int32).tobytes())
    assert (n_items, buf, digest.hexdigest()) == _BENCH_WORK_LISTS[matrix, elem_bytes]
    assert not paneled and (items[:, 9] == 0).all()
    g = np.asarray(sizes)
    assert [int(r1) for r1 in items[:, 10]] == [int(g[b0:b1].max()) for b0, b1 in items[:, 5:7]]
