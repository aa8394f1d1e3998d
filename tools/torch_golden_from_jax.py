"""Golden uscat(0) values of the bench configurations, from the JAX package.

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

With --4d it solves chip_smoke.py phase 8's 4D anchor instead: the "bba"
tree, 16 unit spheres at the corners of the hypercube {-2, 2}^4 (pitch
4), n_end=12, plane wave along x0, the first KB points of
linspace(3.5, 4.5, 100) cast to float32, on the JAX package's default
route (a direct LU on the CPU), and writes bench4d_golden_f64.json.

With --2d it solves chip_smoke.py phase 9's 2D anchors instead, each on
the JAX package's default route in float64 on the CPU (unit spheres, k =
1, a plane wave along x0): the 8 x 8 'a' lattice at pitch 4 (the
n_balls family, 64 spheres: its lattice-FFT route), n_end=19; the 'a'
pair at (0, +-2), n_end=9; the pair at k = 16, n_end=32 with the incident
wave at k = 1 (the accuracy sweep's convention); and writes
nballs2d_golden_f64.json.

    python tools/torch_golden_from_jax.py [--n-k 4]
    python tools/torch_golden_from_jax.py --imag 0.1
    python tools/torch_golden_from_jax.py --4d
    python tools/torch_golden_from_jax.py --2d
    python tools/torch_golden_from_jax.py --caa

With --tests [MODULE ...] it reruns the JAX calls of the port's CPU tests
that read committed JAX values (each module's `jax_golden()`; default:
every module of TEST_MODULES) and rewrites tests/golden/<module>.npz.

    python tools/torch_golden_from_jax.py --tests [test_torch_ctrees ...]

With --caa it solves the anchors of the trees with a 'c' node
(chip_smoke.py phase 10 and tests/test_torch_ctrees.py), each on the JAX
package's default route in float64 on the CPU (unit spheres, a plane
wave along x0): the 'caa' pair at (0, +-2, 0, 0), k = 1, n_end=6; the
'bcaa' pair (the same along x1 in 5D) at n_end=4; the 'cbaba' pair (6D)
at n_end=3; the 'caa' hypercube {-2, 2}^4 (16 spheres) at n_end=6 for the
first KB points of linspace(3.5, 4.5, 100) cast to float32; and the 8 x 8
'caa' lattice at pitch 4 in the x0-x1 plane, k = 1, n_end=3 (its
lattice-FFT route).  It writes their uscat(0), and the densities of the
pairs and the lattice, to caa4d_golden_f64.json.
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
N_END_4D = 12
SWEEP_4D = (3.5, 4.5, 100)


def hypercube_centers(half=2.0, d=4):
    """The 2^d corners of {-half, half}^d, first axis slowest."""
    grid = np.stack(np.meshgrid(*([[-half, half]] * d), indexing="ij"), axis=-1)
    return grid.reshape(-1, d)


def lattice_centers(n_side, spacing, d=3):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0] = xx.ravel()
    centers[:, 1] = yy.ravel()
    return centers


# phase 9's 2D anchors: (name, centers, k, k of the incident wave, n_end)
ANCHORS_2D = (
    ("lattice 8x8", lattice_centers(8, SPACING, d=2), 1.0, 1.0, 19),
    ("pair", np.array([[0.0, 2.0], [0.0, -2.0]]), 1.0, 1.0, 9),
    ("pair k=16", np.array([[0.0, 2.0], [0.0, -2.0]]), 16.0, 1.0, 32),
)


def two_d():
    """Solve ANCHORS_2D with the JAX package and write their uscat(0)."""
    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types

    c = create_from_branching_types("a")
    rows = []
    for name, centers, k, uin_k, n_end in ANCHORS_2D:
        uin, _ = plane_wave(k=np.asarray(uin_k), direction=np.array([1.0, 0.0]))
        t0 = time.perf_counter()
        calc = biem(c, centers=centers, radii=np.ones(len(centers)), k=np.asarray(k),
                    n_end=n_end, uin=uin)
        u0 = complex(np.asarray(calc.uscat(np.zeros((2, 1))).to_numpy()).ravel()[0])
        rows.append({
            "name": name, "n_balls": len(centers), "k": k, "uin_k": uin_k, "n_end": n_end,
            "uscat0": [u0.real, u0.imag],
            "relres": None if calc.relres is None else float(np.asarray(calc.relres)),
            "iters": None if calc.iters is None else int(np.asarray(calc.iters)),
        })
        print(f"{name} n_end={n_end} uscat(0)={u0:.12g} relres={rows[-1]['relres']} "
              f"iters={rows[-1]['iters']} {time.perf_counter() - t0:.1f}s", flush=True)
    return {
        "source": "tools/torch_golden_from_jax.py --2d (JAX package, CPU, float64)",
        "config": {"tree": "a", "radius": 1.0, "spacing": SPACING, "direction": [1.0, 0.0],
                   "solver": "auto (the JAX package's default route)",
                   "pair": [[0.0, 2.0], [0.0, -2.0]]},
        "points": rows,
    }


# the anchors of --caa: (name, tree, centers, k, n_end, keep the density)
def pair_centers(d):
    centers = np.zeros((2, d))
    centers[0, 1], centers[1, 1] = 2.0, -2.0
    return centers


CTREES = (
    ("pair caa", "caa", pair_centers(4), 1.0, 6, True),
    ("pair bcaa", "bcaa", pair_centers(5), 1.0, 4, True),
    ("pair cbaba", "cbaba", pair_centers(6), 1.0, 3, True),
    *(("hypercube caa", "caa", hypercube_centers(), float(kf), 6, False)
      for kf in np.linspace(*SWEEP_4D).astype(np.float32)[:4]),
    ("lattice 8x8 caa", "caa", lattice_centers(8, SPACING, d=4), 1.0, 3, True),
)


def c_trees():
    """Solve CTREES with the JAX package: uscat(0), and the densities."""
    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types

    rows = []
    for name, tree, centers, k, n_end, keep in CTREES:
        c = create_from_branching_types(tree)
        d = c.c_ndim
        direction = np.zeros(d)
        direction[0] = 1.0
        uin, _ = plane_wave(k=np.asarray(k), direction=direction)
        t0 = time.perf_counter()
        calc = biem(c, centers=centers, radii=np.ones(len(centers)), k=np.asarray(k),
                    n_end=n_end, uin=uin)
        u0 = complex(np.asarray(calc.uscat(np.zeros((d, 1))).to_numpy()).ravel()[0])
        row = {
            "name": name, "tree": tree, "n_balls": len(centers), "k": k, "n_end": n_end,
            "uscat0": [u0.real, u0.imag],
            "relres": None if calc.relres is None else float(np.asarray(calc.relres)),
            "iters": None if calc.iters is None else int(np.asarray(calc.iters)),
        }
        if keep:
            dens = np.asarray(calc.density.to_numpy())
            row["density_shape"] = list(dens.shape)
            row["density"] = [dens.real.ravel().tolist(), dens.imag.ravel().tolist()]
        rows.append(row)
        print(f"{name} k={k:.9g} n_end={n_end} uscat(0)={u0:.12g} relres={row['relres']} "
              f"iters={row['iters']} {time.perf_counter() - t0:.1f}s", flush=True)
    return {
        "source": "tools/torch_golden_from_jax.py --caa (JAX package, CPU, float64)",
        "config": {"radius": 1.0, "direction": "x0", "spacing": SPACING,
                   "solver": "auto (the JAX package's default route)",
                   "pair": "(0, +-2, 0, ...)", "hypercube": "corners of {-2, 2}^4",
                   "lattice": "8 x 8 in the x0-x1 plane"},
        "points": rows,
    }


# the test modules whose JAX values are committed (tests/_jax_golden.py)
TEST_MODULES = (
    "test_torch_2d", "test_torch_band_sr", "test_torch_biem", "test_torch_complex_k",
    "test_torch_dense",
    "test_torch_ctrees", "test_torch_dims", "test_torch_graf", "test_torch_gumerov",
    "test_torch_kernels", "test_torch_lattice", "test_torch_matfree", "test_torch_parallel",
    "test_torch_surfaces", "test_torch_trees", "test_torch_frontends", "test_torch_plane_rhs",
)


def tests_golden(names):
    """Run each module's jax_golden() and write tests/golden/<module>.npz."""
    import importlib

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _jax_golden

    for name in names or TEST_MODULES:
        t0 = time.perf_counter()
        arrays = importlib.import_module(name).jax_golden()
        _jax_golden.save(name, arrays)
        print(f"{name}: {len(arrays)} arrays, {sum(a.size for a in arrays.values())} values, "
              f"{time.perf_counter() - t0:.1f}s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-k", type=int, default=4)
    ap.add_argument("--imag", type=float, default=0.0, help="Im k of every point")
    ap.add_argument("--4d", dest="four_d", action="store_true",
                    help="the 4D hypercube anchor (chip_smoke.py phase 8)")
    ap.add_argument("--2d", dest="two_d", action="store_true",
                    help="the 2D anchors (chip_smoke.py phase 9)")
    ap.add_argument("--caa", action="store_true",
                    help="the anchors of trees with a 'c' node (chip_smoke.py phase 10)")
    ap.add_argument("--tests", nargs="*", default=None, metavar="MODULE",
                    help="the committed JAX values of the CPU tests (tests/golden)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if (args.four_d or args.two_d or args.caa) and args.imag:
        ap.error("--4d, --2d and --caa take a real k")
    name = ("caa4d_golden_f64.json" if args.caa else
            "nballs2d_golden_f64.json" if args.two_d else
            "bench4d_golden_f64.json" if args.four_d else
            "bench_golden_complexk_f64.json" if args.imag else "bench_golden_f64.json")
    out_path = args.out or os.path.join(DATA, name)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    if args.tests is not None:
        tests_golden(args.tests)
        return
    if args.two_d or args.caa:
        write(out_path, two_d() if args.two_d else c_trees())
        return
    from biem_helmholtz_sphere_tpu import biem, plane_wave
    from biem_helmholtz_sphere_tpu.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu.ops.cplx import C

    if args.four_d:
        c = create_from_branching_types("bba")
        centers, n_end, sweep = hypercube_centers(), N_END_4D, SWEEP_4D
        solve_kw = {}
    else:
        c = create_from_branching_types("ba")
        centers, n_end, sweep = lattice_centers(N_SIDE, SPACING), N_END, SWEEP
        solve_kw = dict(solver="matfree", stable=True)
    d = c.c_ndim
    direction = np.zeros(d)
    direction[0] = 1.0
    radii = np.ones(len(centers))
    ks = np.linspace(*sweep).astype(np.float32)[: args.n_k]
    rows = []
    for kf in ks:
        k = np.asarray(float(kf))
        if args.imag:
            k = C(k, np.asarray(args.imag))
        uin, _ = plane_wave(k=k, direction=direction)
        t0 = time.perf_counter()
        calc = biem(c, centers=centers, radii=radii, k=k, n_end=n_end, uin=uin, **solve_kw)
        u0 = complex(np.asarray(calc.uscat(np.zeros((d, 1))).to_numpy()).ravel()[0])
        dt = time.perf_counter() - t0
        rows.append({
            "k": [float(kf), args.imag] if args.imag else float(kf),
            "uscat0": [u0.real, u0.imag],
            "relres": None if calc.relres is None else float(np.asarray(calc.relres)),
            "iters": None if calc.iters is None else int(np.asarray(calc.iters)),
        })
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(f"k={kf:.9g}{args.imag:+g}j uscat(0)={u0:.12g} relres={rows[-1]['relres']} "
              f"iters={rows[-1]['iters']} {dt:.1f}s peak_rss={peak:.2f}GiB",
              flush=True)
    if args.four_d:
        config = {
            "tree": "bba", "n_end": N_END_4D, "centers": "corners of {-2, 2}^4",
            "spacing": 4.0, "radius": 1.0, "direction": direction.tolist(),
            "solver": "auto (a direct LU on the CPU)", "stable": False,
            "k_sweep": "linspace(3.5, 4.5, 100) as float32, first points",
        }
    else:
        config = {
            "tree": "ba", "n_end": N_END, "lattice": [N_SIDE, N_SIDE],
            "spacing": SPACING, "radius": 1.0, "direction": direction.tolist(),
            "solver": "matfree", "stable": True, "gmres_tol": 1e-11,
            "k_sweep": "linspace(7, 9, 100) as float32, first points",
            "imag_k": args.imag,
        }
    write(out_path, {
        "source": "tools/torch_golden_from_jax.py (JAX package, CPU, float64)",
        "config": config,
        "points": rows,
    })


def write(out_path, out):
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print("wrote", out_path)


if __name__ == "__main__":
    main()
