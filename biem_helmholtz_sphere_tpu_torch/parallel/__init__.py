"""Several cards (or CPU ranks) on one problem, on torch.distributed.

The JAX package (biem_helmholtz_sphere_tpu.parallel) leaves the
partitioning to XLA's SPMD partitioner (NamedSharding and sharding
constraints); here each rank is one process with one device and the data
movement is written out: `all_gather_into_tensor`, `all_reduce` and
`all_to_all_single`, nothing else (no DTensor).

Process model: every rank calls a function with the same arguments; the
result is replicated on every rank, the same bits on each.  The mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the initialized default
group: NCCL on the cards (rank r on cuda:r % device_count), gloo with CPU
tensors (device="cpu", as the CPU tests run it).

  *  `make_mesh`     - the mesh over every rank.
  *  `sharded_sweep` - a k sweep split over the ranks: each solves its
     contiguous share of the ks in one batched `biem()` call and evaluates
     uscat there; one all-gather.
  *  `sharded_uscat` - the field at [d, N] points split by columns, the
     solved calculator replicated (every rank solved the same system).
  *  `sharded_solve` - ONE system split over the ranks: the dense matrix by
     rows (KD's row window), the offset table by offsets (matfree=True) or
     the lattice kernel by slabs (lattice=True); GMRES runs replicated.
  *  `dryrun_multichip` (`_dryrun.py`) - the four patterns at tiny shapes
     in spawned ranks.
"""

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..biem import biem, plane_wave
from ..biem._core import (
    _assemble,
    _check_biem_inputs,
    _offset_table_operator,
    _offsets,
    _rhs_dispatch,
)
from ..biem._lattice import lattice_operator, lattice_routing
from ..harmonics._index import basis
from ..ops.gmres import gmres_solve_op
from ._dryrun import dryrun_multichip

__all__ = ["dryrun_multichip", "make_mesh", "sharded_solve", "sharded_sweep",
           "sharded_uscat"]


def make_mesh(n_devices=None, axis_names=("sweep",), shape=None, device=None):
    """The DeviceMesh over every rank of the initialized default group.

    n_devices: the world size (the mesh covers all ranks); shape: a tuple
    matching axis_names (default: all ranks on the first axis); device:
    "cuda" (the default: rank r on cuda:r % device_count, NCCL) or "cpu"
    (gloo).  Raises if no process group is initialized, or if CUDA is
    absent and device="cpu" was not asked for.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; every rank calls "
            "torch.distributed.init_process_group first"
        )
    dev_type = torch.device("cuda" if device is None else device).type
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the group has {world} ranks")
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: CUDA is not available (device='cpu' asks for CPU ranks)"
            )
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    elif dev_type != "cpu":
        raise ValueError(f"make_mesh: device {device!r} is neither 'cuda' nor 'cpu'")
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(dev_type, tuple(shape), mesh_dim_names=tuple(axis_names))


@dataclass
class _Axis:
    """One mesh axis: this rank, the group's size, the device, and its
    collectives; with timed, each collective runs between device
    synchronizations and its wall time adds to `seconds`."""

    group: object
    rank: int
    world: int
    device: torch.device
    timed: bool = False
    seconds: float = 0.0
    calls: dict = field(default_factory=dict)

    @classmethod
    def of(cls, mesh, axis_name, timed=False):
        group = mesh.get_group(axis_name)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
        return cls(group, dist.get_rank(group), dist.get_world_size(group), dev, timed)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, name, fn):
        self.calls[name] = self.calls.get(name, 0) + 1
        if not self.timed:
            return fn()
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        self.seconds += time.perf_counter() - t0
        return out

    def all_gather(self, t):
        """Every rank's t, concatenated along the first axis in rank order."""
        t = t.contiguous()
        out = t.new_empty((self.world * t.shape[0],) + tuple(t.shape[1:]))
        self._run("all_gather_into_tensor",
                  lambda: dist.all_gather_into_tensor(out, t, group=self.group))
        return out

    def all_reduce(self, t):
        """The sum of every rank's t, in place."""
        self._run("all_reduce", lambda: dist.all_reduce(t, group=self.group))
        return t

    def all_to_all(self, out, inp, out_splits, in_splits):
        """inp's pieces (in_splits, in rank order) to each rank; out gets
        every rank's piece for this one (out_splits)."""
        self._run("all_to_all_single", lambda: dist.all_to_all_single(
            out, inp, out_splits, in_splits, group=self.group))
        return out


def _stats_of(stats, ax, t0, **kw):
    """Fill a caller's stats dict: wall seconds of the call, the part of it
    inside collectives, their counts, and kw."""
    if stats is not None:
        ax._sync()
        stats.update(total_s=time.perf_counter() - t0, collective_s=ax.seconds,
                     collectives=dict(ax.calls), world=ax.world, **kw)


def _share(n, world, rank):
    """Rank's contiguous share [lo, hi) of n items split evenly (n % world
    == 0 is the caller's check)."""
    per = n // world
    return rank * per, (rank + 1) * per


def _nonzero(v):
    return bool(torch.as_tensor(v).ne(0).any())


def sharded_sweep(c, *, centers, radii, ks, n_end, direction, alpha=1.0, beta=0.0,
                  eta=None, x=None, mesh=None, axis_name="sweep", _stats=None):
    """Solve the BIEM for every k in `ks` with the sweep split over the ranks.

    centers [B, d], radii [B] (shared geometry); ks [NK] (real or complex);
    direction [d].  Returns uscat at x (default: the origin) [NK] on every
    rank.  NK must be divisible by the number of ranks.  Rank r solves ks
    of its share in one batched `biem()` call (its default route) and
    evaluates uscat there; one all-gather joins the shares.  _stats: a dict
    to fill with the call's seconds and the part of them in collectives.
    """
    t0 = time.perf_counter()
    if mesh is None:
        mesh = make_mesh(axis_names=(axis_name,))
    ax = _Axis.of(mesh, axis_name, timed=_stats is not None)
    ks = torch.as_tensor(ks, device=ax.device)
    nk = ks.shape[0]
    if nk % ax.world:
        raise ValueError(f"sharded_sweep: {nk} ks do not split over {ax.world} ranks")
    lo, hi = _share(nk, ax.world, ax.rank)
    ks_r = ks[lo:hi]
    rdt = torch.promote_types(ks.real.dtype, torch.float32)
    centers = torch.as_tensor(centers, device=ax.device)
    radii = torch.as_tensor(radii, device=ax.device)
    n_balls, d = centers.shape[-2], c.c_ndim
    per = hi - lo
    dir_b = torch.as_tensor(direction, device=ax.device)[:, None].expand(d, per)
    eta_b = (torch.ones(per, dtype=rdt, device=ax.device) if eta is None
             else torch.as_tensor(eta, device=ax.device).expand(nk)[lo:hi])
    uin, uin_grad = plane_wave(k=ks_r, direction=dir_b)
    calc = biem(
        c,
        centers=centers.expand(per, n_balls, d),
        radii=radii.expand(per, n_balls),
        k=ks_r,
        n_end=n_end,
        alpha=alpha,
        beta=beta,
        uin=uin,
        uin_grad=uin_grad if _nonzero(beta) else None,
        eta=eta_b,
    )
    if x is None:
        x = torch.zeros((d, 1), dtype=rdt, device=ax.device)
    out = ax.all_gather(calc.uscat(x)[0])
    _stats_of(_stats, ax, t0)
    return out


def sharded_uscat(calc, x, mesh=None, axis_name="points", _stats=None, **kw):
    """calc.uscat(x, **kw) with the points split over the ranks.

    x: [d, N] with N divisible by the number of ranks; calc is the same
    solved state on every rank, on its own device.  Rank r evaluates its
    contiguous block of columns (KA on "ba", the harmonic sum otherwise);
    one all-gather joins them: [N, ...] on every rank.
    """
    t0 = time.perf_counter()
    if mesh is None:
        mesh = make_mesh(axis_names=(axis_name,))
    ax = _Axis.of(mesh, axis_name, timed=_stats is not None)
    dens = calc.density
    x = torch.as_tensor(x, dtype=dens.real.dtype, device=dens.device)
    n = x.shape[1]
    if x.ndim != 2 or n % ax.world:
        raise ValueError(f"sharded_uscat: x {tuple(x.shape)} is not [d, N] with N divisible "
                         f"by {ax.world} ranks")
    lo, hi = _share(n, ax.world, ax.rank)
    out = ax.all_gather(calc.uscat(x[:, lo:hi], **kw))
    _stats_of(_stats, ax, t0)
    return out


def _dense_rows_operator(c, n_end, centers_np, radii, k, eta, alpha, beta, ax, cdt):
    """(mv, diag) of the row-sharded dense system: rank r assembles rows
    [r0, r1) of the [B H, B' H'] matrix (KD's row window, ceil(n / world)
    rows a rank; a window may cut a ball's rows); mv all-gathers A_rows x,
    diag the rows' diagonal entries."""
    n_balls = radii.shape[-1]
    n = n_balls * basis(c, n_end).num
    if n < ax.world:
        raise ValueError(f"sharded_solve: {n} rows do not go round {ax.world} ranks")
    per = -(-n // ax.world)
    r0, r1 = min(n, ax.rank * per), min(n, (ax.rank + 1) * per)
    if r1 > r0:
        a = _assemble(c, n_end, centers_np, radii, k, eta, alpha, beta,
                      rows=(r0, r1)).reshape(r1 - r0, n)
        own = a.diagonal(offset=r0)
    else:  # a rank past the last row
        a = torch.zeros((0, n), dtype=cdt, device=radii.device)
        own = a[:, 0]

    def rows_of(v):  # my rows [r1 - r0] -> all n rows, padded to per a rank
        pad = v.new_zeros((per,))
        pad[: r1 - r0] = v
        return ax.all_gather(pad)[:n]

    diag = rows_of(own)[None]

    def mv(x_flat):
        return rows_of(a @ x_flat[0])[None]

    mv.stored_bytes = a.numel() * a.element_size()
    return mv, diag


def sharded_solve(c, *, centers, radii, k, n_end, direction, alpha=1.0, beta=0.0,
                  eta=None, mesh=None, axis_name="rows", tol=None, matfree=False,
                  lattice=False, _stats=None):
    """Solve ONE BIEM system with its operator split over the ranks.

    centers [B, d], radii [B], k a scalar, direction [d]; a plane wave.
    Returns the density [B, H] on every rank.  As in the JAX package, the
    dense and lattice operators are unscaled (they overflow float32 from
    n_end ~ k t_min + 20, as `biem(stable=False)` does) and the offset
    table is scale-compensated in float32 (`biem()`'s dtype rule); GMRES
    (ops/gmres.py, tol as there) runs replicated on every rank: its basis
    is m n, small against the operator.

    * dense (default): rank r assembles only rows [r0, r1) of the
      [B H, B' H'] matrix (KD's row window; ceil(B H / world) rows a rank,
      so a window may cut a ball's rows); the matvec all-gathers A_rows x,
      and the Jacobi diagonal comes from each rank's rows.  Per-rank
      matrix bytes: (r1 - r0) B H itemsize.
    * matfree=True: the offset-table operator (`_core._offset_table_operator`)
      with rank r's table [NO_r, H, H] built for its contiguous share of
      the distinct offsets alone (K5 + K2 and the sandwich, or KG in 2D)
      and its lanes alone applied; the per-sphere shares are summed by one
      all_reduce per matvec, the diagonal term on rank 0's share.  The
      dense matrix is never formed; per-rank table bytes NO_r H^2 itemsize.
    * lattice=True (implies matfree): the lattice-FFT operator with the
      half table and the kernel built by slabs and kept by Fy columns
      (`biem._lattice`: one all_to_all at build, one all_gather per
      matvec); per-rank kernel bytes Fx ceil(Fy / world) H^2 itemsize.
      Raises ValueError off a uniform lattice.

    _stats: a dict to fill with the call's seconds, the part of them in
    collectives and the bytes of this rank's operator ("bytes") beside the
    whole operator's on one device ("whole_bytes").
    """
    t0 = time.perf_counter()
    if mesh is None:
        mesh = make_mesh(axis_names=(axis_name,))
    ax = _Axis.of(mesh, axis_name, timed=_stats is not None)
    dev = ax.device
    centers_np = np.asarray(torch.as_tensor(centers).cpu(), dtype=np.float64)
    if lattice and lattice_routing(centers_np) is None:
        raise ValueError("lattice=True requires a uniform-lattice geometry")
    k = torch.as_tensor(k, device=dev)
    if k.ndim:
        raise ValueError(f"sharded_solve: k must be a scalar, got {tuple(k.shape)}")
    uin, uin_grad = plane_wave(k=k, direction=torch.as_tensor(direction, device=dev))
    centers_c, radii_c, k_c, eta_c, alpha_c, beta_c, rdt = _check_biem_inputs(
        c, torch.as_tensor(centers, device=dev), torch.as_tensor(radii, device=dev), k, eta,
        alpha, beta)
    n_balls = radii_c.shape[-1]
    h_num = basis(c, n_end).num
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    radii_f = radii_c.to(rdt).reshape(1, n_balls)
    k_f = k_c.to(cdt if k_c.is_complex() else rdt).reshape(1)
    eta_f = eta_c.reshape(1)
    alpha_f = alpha_c.expand(n_balls).reshape(1, n_balls)
    beta_f = beta_c.expand(n_balls).reshape(1, n_balls)
    centers_t = torch.as_tensor(centers_np, dtype=rdt, device=dev)
    f = _rhs_dispatch(c, n_end, centers_t, radii_f, alpha_f, beta_f, uin,
                      uin_grad if _nonzero(beta) else None, ()).reshape(1, n_balls * h_num)
    args = (c, n_end, centers_np, radii_f, k_f, eta_f, alpha_f, beta_f)
    itemsize = torch.empty((), dtype=cdt).element_size()
    if lattice:
        mv, diag = lattice_operator(*args, part=ax)
        _, _, (lx, ly), _, _ = lattice_routing(centers_np)
        whole = 4 * lx * ly * h_num * h_num * itemsize
    elif matfree:
        n_off = len(_offsets(centers_np)[0])
        per = -(-n_off // ax.world)
        share = slice(min(n_off, ax.rank * per), min(n_off, (ax.rank + 1) * per))
        part_mv, diag = _offset_table_operator(*args, None, None, rdt == torch.float32,
                                               offsets=share, with_diag=ax.rank == 0)

        def mv(x_flat):
            return ax.all_reduce(part_mv(x_flat))

        mv.stored_bytes = part_mv.stored_bytes
        whole = n_off * h_num * h_num * itemsize
    else:
        mv, diag = _dense_rows_operator(*args, ax, cdt)
        whole = (n_balls * h_num) ** 2 * itemsize
    x, _, _ = gmres_solve_op(mv, diag, f, tol=tol)
    _stats_of(_stats, ax, t0, bytes=mv.stored_bytes, whole_bytes=whole)
    return x.reshape(n_balls, h_num)
