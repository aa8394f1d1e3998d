"""KC: routing of sphere vectors into pair lanes and back.

The factored (S|R) matvec works on "lanes": one row per (offset slot,
pair) that routes a pair, a b < b' pair or its mirror, compacted (no
padding lane) and sorted by slot (see biem._core._pair_routing).
`lane_gather` fills the lanes with blc * x of each lane's source ball,
times the parity (-1)^n on mirror sources, one source row at a time
(the by-source CSR `src_ptr`/`src_lane`); `lane_scatter` applies the
parity to the mirror lanes, sums each destination ball's lanes in a
fixed CSR order and adds the diagonal: out = diag * x + reg * sum.  The JAX package does both with one-hot
routing matmuls (biem_helmholtz_sphere_tpu/biem/_core.py, the factored
`mv`).  On CUDA tensors both run the kernels of `csrc/lane_route.cu`,
with no atomics, so the sum order never changes between runs; on CPU
tensors the plain versions below.
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import kernels


@dataclass(frozen=True)
class LaneRoute:
    """Integer routing tables of the pair lanes (on the operator's device)."""

    src: torch.Tensor  # int32 [L]: source row of [z; z*pm] (b' or B + b)
    dst: torch.Tensor  # int64 [L]: destination ball
    dn: torch.Tensor  # bool [L]: mirror lane (parity applied to its output)
    csr_ptr: torch.Tensor  # int32 [B+1]
    csr_lane: torch.Tensor  # int32 [nnz]: lanes of each ball, ascending
    csr_dn: torch.Tensor  # int32 [nnz]: mirror flag of each listed lane
    src_ptr: torch.Tensor  # int32 [2B+1]: lanes of each source row (by-source CSR)
    src_lane: torch.Tensor  # int32 [L]: the lanes of each source row, ascending
    n_balls: int


def make_route(src, dst, dn, n_balls, device):
    """Tables from the compacted lane arrays (src, dst, dn as from
    biem._core._pair_routing)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    dn = np.asarray(dn, dtype=bool)
    if (src < 0).any() or (dst < 0).any():
        raise ValueError("make_route: every lane must route a pair")
    if (src >= 2 * n_balls).any() or (dst >= n_balls).any():
        raise ValueError("make_route: a lane routes a ball that does not exist")
    lanes = [np.nonzero(dst == b)[0] for b in range(n_balls)]
    ptr = np.concatenate([[0], np.cumsum([len(v) for v in lanes])])
    csr_lane = np.concatenate(lanes)
    # the gather's CSR: the lanes of each source row, ascending
    src_lane = np.argsort(src, kind="stable")
    src_ptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=2 * n_balls))])

    def t(a, dt=torch.int32):
        return torch.as_tensor(a, dtype=dt, device=device)

    return LaneRoute(
        src=t(src), dst=t(dst, torch.int64), dn=t(dn, torch.bool),
        csr_ptr=t(ptr), csr_lane=t(csr_lane), csr_dn=t(dn[csr_lane]),
        src_ptr=t(src_ptr), src_lane=t(src_lane), n_balls=n_balls,
    )


def _check(name, pm, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in (*tensors, pm)):
        kernels._device_error(name, (*tensors, pm))  # the kernel reads one card
    dt = tensors[0].dtype
    if dt not in kernels.REAL_OF:
        raise TypeError(f"{name}: dtype {dt}")
    if any(t.dtype != dt for t in tensors):
        raise TypeError(f"{name}: operands differ in dtype")
    if pm.dtype != kernels.REAL_OF[dt]:
        raise TypeError(f"{name}: parity must be real {kernels.REAL_OF[dt]}")


def _lane_gather_plain(x, blc, pm, route):
    z = blc * x
    zs = torch.cat([z, z * pm], dim=-2)  # [K, 2B, H]
    return zs.index_select(-2, route.src.long())


def lane_gather(x, blc, pm, route):
    """lanes[k, l, :] = [blc*x; blc*x*pm][k, src[l], :].

    x, blc: complex [K, B, H]; pm: real [H]; returns complex [K, L, H].
    """
    if x.device.type == "cpu":
        return _lane_gather_plain(x, blc, pm, route)
    _check("lane_gather", pm, x, blc)
    n_k, n_b, h = x.shape
    n_lanes = route.src_lane.shape[0]
    x, blc, pm = x.contiguous(), blc.contiguous(), pm.contiguous()
    lanes = torch.empty((n_k, n_lanes, h), dtype=x.dtype, device=x.device)
    kernels.launch(
        "bhs_lane_gather", x, blc, pm, route.src_ptr, route.src_lane, lanes, n_k, n_b,
        n_lanes, h,
        int(x.dtype == torch.complex128),
    )
    lane_gather.launches += 1
    return lanes


lane_gather.launches = 0


def _lane_scatter_plain(y, x, diag, reg, pm, route):
    y = torch.where(route.dn[:, None], y * pm, y)
    cpl = torch.zeros_like(x).index_add_(-2, route.dst, y)
    return diag * x + reg * cpl


def lane_scatter(y, x, diag, reg, pm, route):
    """out[k, b, :] = diag*x + reg * sum over the lanes l of ball b of
    (pm if l is a mirror lane else 1) * y[k, l, :].

    y: complex [K, L, H]; x, diag, reg: complex [K, B, H]; pm: real [H].
    """
    if x.device.type == "cpu":
        return _lane_scatter_plain(y, x, diag, reg, pm, route)
    _check("lane_scatter", pm, y, x, diag, reg)
    n_k, n_b, h = x.shape
    y, x, diag, reg, pm = (t.contiguous() for t in (y, x, diag, reg, pm))
    out = torch.empty_like(x)
    kernels.launch(
        "bhs_lane_scatter", y, x, diag, reg, pm, route.csr_ptr, route.csr_lane,
        route.csr_dn, out, n_k, n_b, y.shape[1], h,
        int(x.dtype == torch.complex128),
    )
    lane_scatter.launches += 1
    return out


lane_scatter.launches = 0
