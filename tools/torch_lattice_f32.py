"""How far the float32 lattice solves are from float64, on the card and on
the CPU.

    python tools/torch_lattice_f32.py LABEL

Run from the repository root on a machine with a CUDA card and nvcc (no
JAX needed).  The case is tests/test_torch_cuda.py::
test_lattice_solve_on_the_card_matches_the_cpu's: the 8 x 8 lattice of
unit circles ('a', n_end = 12, the lattice-FFT route) and of unit spheres
('ba', n_end = 5), a plane wave, solver "auto", stable and plain.  For
each tree, stable flag, wave number k and in-plane direction (angle from
the x0 axis), it solves in float32 on the card and on the CPU and in
float64 on the CPU, and prints one JSON line per case: the density's and
uscat((3, 0, ..))'s largest difference relative to the reference's
largest entry, for card float32 against CPU float32 (what the test gates
at 1e-4), card float32 against float64 and CPU float32 against float64.
To run it on the parent's tree in turns with this one:
`python tools/ab_common.py PARENT_DIR tools/torch_lattice_f32.py`.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.ab_common import card_line  # noqa: E402

KS = (1.0, 1.4)
ANGLES = (0.0, 0.5, 1.2)


def lattice(n_side, d, spacing=4.0):
    import numpy as np

    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0], centers[:, 1] = xx.ravel(), yy.ravel()
    return centers


def solve(torch, device, tree, rdt, n_end, k, angle, stable):
    """(density, uscat at (3, 0, ..)) on the CPU."""
    import math

    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    c = create_from_branching_types(tree)
    f = dict(dtype=rdt, device=device)
    kt = torch.as_tensor(k, **f)
    direction = torch.zeros(c.c_ndim, **f)
    direction[0], direction[1] = math.cos(angle), math.sin(angle)
    uin, _ = plane_wave(k=kt, direction=direction)
    centers = lattice(8, c.c_ndim)
    calc = biem(c, centers=torch.as_tensor(centers, **f), radii=torch.ones(len(centers), **f),
                k=kt, n_end=n_end, uin=uin, stable=stable)
    x = torch.zeros(c.c_ndim, 1, **f)
    x[0] = 3.0
    return calc.density.cpu().to(torch.complex128), calc.uscat(x).cpu().to(torch.complex128)


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_lattice_f32: CUDA is not available", file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for tree, n_end in (("a", 12), ("ba", 5)):
        for stable in (True, False):
            for k in KS:
                for angle in ANGLES if tree == "a" else ANGLES[:1]:
                    card = solve(torch, dev, tree, torch.float32, n_end, k, angle, stable)
                    c32 = solve(torch, cpu, tree, torch.float32, n_end, k, angle, stable)
                    c64 = solve(torch, cpu, tree, torch.float64, n_end, k, angle, stable)
                    row = {"tree": tree, "stable": stable, "k": k, "angle": angle}
                    for i, name in enumerate(("density", "uscat")):
                        row[name] = {"card32-cpu32": rel(card[i], c32[i]),
                                     "card32-f64": rel(card[i], c64[i]),
                                     "cpu32-f64": rel(c32[i], c64[i])}
                    print(sys.argv[1], json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
