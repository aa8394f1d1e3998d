"""The multi-rank dry run: the four sharded patterns at tiny shapes.

    python -c "from biem_helmholtz_sphere_tpu_torch.parallel import \\
        dryrun_multichip; dryrun_multichip(2)"            # NCCL, two cards
    ... dryrun_multichip(2, device="cpu")                  # gloo, CPU ranks

The counterpart of the JAX package's `__graft_entry__.dryrun_multichip`
(the same patterns and shapes): spawned ranks meet through a FileStore in
a temporary directory, NCCL on n cards (rank r on cuda:r), or gloo with
CPU tensors when device="cpu" asks for it.  With fewer cards it raises: it
does not stand CPU ranks in for missing cards.
"""

import os
import tempfile
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this has lost a rank
_TIMEOUT = timedelta(seconds=300)


def dryrun_multichip(n_devices, device=None):
    """Run the sweep, the points, the row-sharded dense system and the 2D
    lattice on n_devices ranks; raise if any rank fails or gives a
    non-finite or misshapen result.  device: None or "cuda" (NCCL, needs
    n_devices cards) or "cpu" (gloo ranks on the CPU)."""
    dev_type = torch.device("cuda" if device is None else device).type
    if dev_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip: {n_devices} ranks need {n_devices} CUDA cards, "
                f"{have} found (device='cpu' runs gloo ranks on the CPU)"
            )
    elif dev_type != "cpu":
        raise ValueError(f"dryrun_multichip: device {device!r} is neither 'cuda' nor 'cpu'")
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_patterns, n_devices, tmp, dev_type)


def spawn_ranks(fn, n_ranks, store_dir, device, *args, backend=None):
    """Run fn(rank, n_ranks, device, *args) in n_ranks spawned processes
    joined in one process group through a FileStore in store_dir; raise if
    a rank fails.  backend: NCCL on "cuda" and gloo on "cpu" by default
    (gloo with CUDA tensors puts several ranks on one card)."""
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    mp.spawn(_group_main,
             args=(n_ranks, fn, os.path.join(store_dir, "store"), device, backend, args),
             nprocs=n_ranks, join=True)


def _group_main(rank, world, fn, store_path, device, backend, args):
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=_TIMEOUT)
    try:
        fn(rank, world, device, *args)
    finally:
        dist.destroy_process_group()


def _patterns(rank, world, device):
    from ..biem import biem, plane_wave
    from ..coords import create_from_branching_types
    from . import make_mesh, sharded_solve, sharded_sweep, sharded_uscat

    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" \
        else torch.device("cpu")
    f64 = dict(dtype=torch.float64, device=dev)
    c = create_from_branching_types("ba")
    centers = torch.tensor([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]], **f64)
    radii = torch.ones(2, **f64)
    direction = torch.tensor([1.0, 0.0, 0.0], **f64)

    def check(name, u, shape):
        if tuple(u.shape) != shape or not bool(torch.isfinite(u).all()):
            raise RuntimeError(f"dryrun_multichip rank {rank}: {name} gave {tuple(u.shape)}, "
                               f"finite {bool(torch.isfinite(u).all())}; expected {shape}")

    # 1) the sweep split over the ranks: assembly, solve and evaluation
    ks = torch.as_tensor(np.linspace(0.8, 1.2, 2 * world), **f64)
    u = sharded_sweep(c, centers=centers, radii=radii, ks=ks, n_end=4, direction=direction,
                      mesh=make_mesh(world, ("sweep",), device=device))
    check("the sweep", u, (2 * world,))
    # 2) the points split over the ranks, one solved instance on each
    k = torch.tensor(1.0, **f64)
    uin, _ = plane_wave(k=k, direction=direction)
    calc = biem(c, centers=centers, radii=radii, k=k, n_end=4, uin=uin)
    x = torch.zeros((3, 4 * world), **f64)
    x[0] = torch.linspace(3.0, 6.0, 4 * world, **f64)
    u2 = sharded_uscat(calc, x, mesh=make_mesh(world, ("points",), device=device))
    check("the points", u2, (4 * world,))
    # 3) one dense system, its rows split over the ranks
    dens = sharded_solve(c, centers=centers, radii=radii, k=k, n_end=4, direction=direction,
                         mesh=make_mesh(world, ("rows",), device=device))
    check("the row-sharded system", dens, (2, 16))
    # 4) the lattice-FFT solver, its kernel split over the ranks
    g = (np.arange(4) - 1.5) * 4.0
    gx, gy = np.meshgrid(g, g)
    lat = np.stack([gx.ravel(), gy.ravel()], axis=1)
    dens4 = sharded_solve(create_from_branching_types("a"), centers=lat,
                          radii=torch.ones(16, **f64), k=k, n_end=4,
                          direction=torch.tensor([1.0, 0.0], **f64),
                          mesh=make_mesh(world, ("rows",), device=device), lattice=True)
    check("the sharded lattice", dens4, (16, 7))
