"""The rank side of tests/test_torch_parallel.py: what each spawned gloo
rank computes (no JAX here: the ranks import the port alone).

`run` is given to `parallel._dryrun.spawn_ranks`; each rank writes its
results to <out_dir>/rank<r>.npz for the test process to read.
"""

import os

import numpy as np
import torch

PAIR = np.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]])
KS = np.linspace(0.8, 1.2, 16)
POINTS = np.zeros((3, 16))
POINTS[0] = np.linspace(3.0, 6.0, 16)
N_END_LATTICE = 6


def lattice(n_side, d, spacing=4.0):
    """The JAX package's test lattice (tests/test_parallel.py::_lattice)."""
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0] = xx.ravel()
    centers[:, 1] = yy.ravel()
    return centers


def run(rank, world, device, out_dir):
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.parallel import (
        make_mesh,
        sharded_solve,
        sharded_sweep,
        sharded_uscat,
    )

    f64 = dict(dtype=torch.float64)
    out = {}
    try:  # the mesh is on the card unless the CPU is asked for
        make_mesh(world, ("sweep",))
        out["mesh needs cuda"] = np.array(False)
    except RuntimeError:
        out["mesh needs cuda"] = np.array(True)
    ba, a = create_from_branching_types("ba"), create_from_branching_types("a")
    x_dir = torch.tensor([1.0, 0.0, 0.0], **f64)
    pair = torch.as_tensor(PAIR, **f64)
    out["sweep"] = sharded_sweep(
        ba, centers=pair, radii=torch.ones(2, **f64), ks=torch.as_tensor(KS, **f64), n_end=4,
        direction=x_dir, mesh=make_mesh(world, ("sweep",), device="cpu")).numpy()
    k3 = torch.as_tensor(KS[3], **f64)
    uin, _ = plane_wave(k=k3, direction=x_dir)
    calc = biem(ba, centers=pair, radii=torch.ones(2, **f64), k=k3, n_end=4, uin=uin)
    out["uscat"] = sharded_uscat(calc, torch.as_tensor(POINTS, **f64),
                                 mesh=make_mesh(world, ("points",), device="cpu")).numpy()
    solves = {
        "dense": (ba, PAIR, 4, x_dir, {}),
        "matfree": (a, lattice(2, 2), 8, x_dir[:2], {"matfree": True}),
        "lattice": (a, lattice(4, 2), N_END_LATTICE, x_dir[:2], {"lattice": True}),
    }
    for name, (c, centers, n_end, direction, kw) in solves.items():
        stats = {}
        out[name] = sharded_solve(
            c, centers=centers, radii=torch.ones(len(centers), **f64),
            k=torch.tensor(1.0, **f64), n_end=n_end, direction=direction,
            mesh=make_mesh(world, ("rows",), device="cpu"), _stats=stats, **kw).numpy()
        out[f"{name} bytes"] = np.array([stats["bytes"], stats["whole_bytes"]])
        out[f"{name} collectives"] = np.array(sorted(stats["collectives"]))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
