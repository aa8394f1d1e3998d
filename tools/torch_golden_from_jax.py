"""Golden uscat(0) values of the bench configuration, from the JAX package.

Solves the bench configuration (bench.py: "ba" tree, 16 unit spheres on a
4x4 lattice with spacing 4, n_end=32, plane wave along x0) with the JAX
package on the CPU in float64, on the factored matrix-free route
(solver="matfree", stable=True, GMRES tol 1e-11), for the first k-block
of the bench sweep: the first KB points of linspace(7, 9, 100) cast to
float32, plus --imag times i (an absorbing medium; default 0).  Each k is
solved on its own to bound peak memory.

Writes biem_helmholtz_sphere_tpu_torch/data/bench_golden_f64.json (real
k), or bench_golden_complexk_f64.json with --imag (chip_smoke.py phase 7
uses 0.1), which chip_smoke.py reads: the card has no JAX.

    python tools/torch_golden_from_jax.py [--n-k 4]
    python tools/torch_golden_from_jax.py --imag 0.1
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DATA = os.path.join(ROOT, "biem_helmholtz_sphere_tpu_torch", "data")
N_END = 32
N_SIDE = 4
SPACING = 4.0
SWEEP = (7.0, 9.0, 100)


def lattice_centers(n_side, spacing, d=3):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0] = xx.ravel()
    centers[:, 1] = yy.ravel()
    return centers


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-k", type=int, default=4)
    ap.add_argument("--imag", type=float, default=0.0, help="Im k of every point")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out_path = args.out or os.path.join(
        DATA, "bench_golden_complexk_f64.json" if args.imag else "bench_golden_f64.json")

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu.ops.cplx import C

    c = create_from_branching_types("ba")
    centers = lattice_centers(N_SIDE, SPACING)
    radii = np.ones(len(centers))
    ks = np.linspace(*SWEEP).astype(np.float32)[: args.n_k]
    rows = []
    for kf in ks:
        k = np.asarray(float(kf))
        if args.imag:
            k = C(k, np.asarray(args.imag))
        uin, _ = plane_wave(k=k, direction=np.asarray([1.0, 0.0, 0.0]))
        t0 = time.perf_counter()
        calc = biem(
            c, centers=centers, radii=radii, k=k, n_end=N_END, uin=uin,
            solver="matfree", stable=True,
        )
        u0 = complex(calc.uscat(np.zeros((3, 1))).to_numpy().ravel()[0])
        dt = time.perf_counter() - t0
        rows.append({
            "k": [float(kf), args.imag] if args.imag else float(kf),
            "uscat0": [u0.real, u0.imag],
            "relres": float(np.asarray(calc.relres)),
            "iters": int(np.asarray(calc.iters)),
        })
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(f"k={kf:.9g}{args.imag:+g}j uscat(0)={u0:.12g} relres={rows[-1]['relres']:.2e} "
              f"iters={rows[-1]['iters']} {dt:.1f}s peak_rss={peak:.2f}GiB",
              flush=True)
    out = {
        "source": "tools/torch_golden_from_jax.py (JAX package, CPU, float64)",
        "config": {
            "tree": "ba", "n_end": N_END, "lattice": [N_SIDE, N_SIDE],
            "spacing": SPACING, "radius": 1.0, "direction": [1.0, 0.0, 0.0],
            "solver": "matfree", "stable": True, "gmres_tol": 1e-11,
            "k_sweep": "linspace(7, 9, 100) as float32, first points",
            "imag_k": args.imag,
        },
        "points": rows,
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print("wrote", out_path)


if __name__ == "__main__":
    main()
