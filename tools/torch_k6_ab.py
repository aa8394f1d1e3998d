"""GMRES on the card: the bench sweep, the 2D cold rung and the 4D first
block's solve, timed in one process.

    python tools/torch_k6_ab.py LABEL [--lags 1,2,4,8]

Run from the repository root on a machine with a CUDA card and nvcc (no
JAX needed).  In this fresh process, after a warm-up (the kernels built
and loaded, a small 'ba' solve), it measures:

- the bench sweep (`chip_smoke.bench_sweep`: 16 unit spheres, n_end=32,
  complex64, 8 k in two warm-started blocks of 4), once to warm its
  caches, then: the wall seconds per k of an untimed sweep (best of 3);
  phase 4's stage split per k (`chip_smoke.split_stages`: RHS, radial
  rows, K2 with its K5, the solve, uscat(0)); the GMRES iterations of
  each block (the largest over its 4 systems); the device's idle share
  over a sweep under torch.profiler (CUDA activity only; the union of the
  kernels' intervals against the host clock);
- phase 9 (b)'s cold rung: 'a' on the 64 x 64 lattice at n_end=2 (12,288
  unknowns), complex64, one GMRES cycle of basis 4,608 from a cold start
  through `lattice_operator`, its seconds and steps (best of 2);
- phase 8 (a)'s first block's GMRES: 'bba' on {-2, 2}^4 at n_end=20,
  complex64, the first 4 k of the 4D sweep, solver auto (the factored
  GMRES), split as phase 8 (a) does; the first (cold tables) and a
  repeat;
- K6 alone on the device (torch.profiler, every kernel named k6_ a step):
  the Arnoldi step at chip_smoke phase 2's held steps, on its operators
  (the bench block at j = 0, 7, 47; the complex128 offset table at 0, 10,
  20; the cold rung at 0, 580, 1161), each state advanced by the tree's
  own K6 with target 0, and the back-substitution at each state's j_f
  (48, 21, 1,162).

With --lags (only where ops/gmres.py has `_LAG_CUDA`) it repeats the bench
sweep's wall, split, idle share and the cold rung at each lag in the list
(in its order; a lag may repeat, e.g. 2,4,2,4), and prints the GMRES
loop's counts (host reads, steps launched and run) per solve.  To time
the parent's GMRES in turns with this tree's (parent, this, this, parent,
each a fresh process):

    python tools/ab_common.py PARENT_DIR tools/torch_k6_ab.py [--lags ...]

(a tree whose GMRES has no lag skips --lags).  Prints the card, then LABEL
and one JSON object.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.ab_common import busy_us, card_line, warm_up  # noqa: E402


def bench(torch, cs, _core):
    """The bench sweep's wall per k, stage split per k, iterations per
    block and idle share."""
    from torch.profiler import ProfilerActivity, profile

    _, sweep, ks = cs.bench_sweep(torch, torch.device("cuda", 0))
    n_k = len(ks)
    sweep()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = sweep()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    iters = [int(calc.iters.max()) for calc, _ in out]
    stages = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows_scaled", "radial rows"),
              (_core, "coax_fold_packed", "K2 (with its K5)"), (_core, "gmres_solve_op", "solve"),
              (_core.BIEMResultCalculator, "uscat", "uscat(0)")]
    acc, total = cs.split_stages(torch, sweep, stages)
    split = {k: round(v / n_k, 6) for k, v in acc.items()}
    split["other"] = round((total - sum(acc.values())) / n_k, 6)
    split["total"] = round(total / n_k, 6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle = 1.0 - busy_us(prof)[0] * 1e-6 / wall
    return {"per_k_s": round(min(walls) / n_k, 6), "per_k_s_runs": [round(w / n_k, 6) for w in walls],
            "split_per_k": split, "iters_per_block": iters, "idle_share": round(idle, 4)}


def cold_rung(torch, cs, _core, _lattice, gmres_solve_op):
    """Phase 9 (b)'s cold rung: seconds and steps of one cycle of basis
    4,608 at n_end=2 (best of 2)."""
    from biem_helmholtz_sphere_tpu_torch import plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    dev = torch.device("cuda", 0)
    f32 = dict(dtype=torch.float32, device=dev)
    c64 = dict(dtype=torch.complex64, device=dev)
    c = create_from_branching_types("a")
    centers = cs.square_lattice(cs.N_SIDE_2D, 2)
    nb = len(centers)
    uin = plane_wave(k=torch.tensor(1.0, **f32), direction=torch.tensor([1.0, 0.0], **f32))[0]
    ones, k1 = torch.ones(1, nb, **f32), torch.ones(1, **f32)
    alpha, beta = torch.ones(1, nb, **c64), torch.zeros(1, nb, **c64)
    mv, diag = _lattice.lattice_operator(c, 2, centers, ones, k1, k1, alpha, beta, stable=True)
    rhs = _core._rhs_dispatch(c, 2, torch.as_tensor(centers, **f32), ones, alpha, beta, uin,
                              None, (1,)).reshape(1, -1)
    best, steps, relres = float("inf"), None, None
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rr, it = gmres_solve_op(mv, diag, rhs, restart=cs.COLD_RESTART, maxiter=1)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        steps, relres = int(it.max()), float(rr.max())
    return {"s": round(best, 6), "steps": steps, "relres": relres}


def four_d_gmres(torch, cs, _core):
    """Phase 8 (a)'s first block split (cold tables), then a repeat: the
    GMRES stage's seconds and the block's iterations."""
    import numpy as np

    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis

    dev = torch.device("cuda", 0)
    f = dict(dtype=torch.float32, device=dev)
    c4 = create_from_branching_types("bba")
    basis(c4, cs.N_END_4D)
    centers = cs.hypercube_centers()
    kt = torch.as_tensor(np.asarray(cs.sweep_ks_4d()[: cs.KB]), **f)
    n_k = kt.numel()
    direction = torch.zeros(4, n_k, **f)
    direction[0] = 1.0
    out = {}

    def block():
        uin, _ = plane_wave(k=kt, direction=direction)
        calc = biem(c4, centers=torch.as_tensor(centers, **f).expand(n_k, len(centers), 4),
                    radii=torch.ones(n_k, len(centers), **f), k=kt, n_end=cs.N_END_4D, uin=uin)
        out["iters"] = int(calc.iters.max())
        return calc

    stages = [(_core, "gmres_solve_op", "GMRES")]
    for label in ("first block", "repeat"):
        acc, total = cs.split_stages(torch, block, stages)
        out[label] = {"GMRES": round(acc["GMRES"], 6), "total": round(total, 6),
                      "iters": out["iters"]}
    del out["iters"]
    return out


def k6_us_per_call(torch, fn, kernel):
    """Device microseconds per call of fn of the kernels whose names hold
    `kernel` (torch.profiler, 5 calls): each kernel's mean per launch times
    its launches per call, counted and rounded (the profiler may drop a
    short kernel's event), summed over the kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if kernel in e.key and e.count]
        if evs:
            return sum(e.device_time_total / e.count * max(1, round(e.count / 5)) for e in evs)
    raise RuntimeError(f"torch.profiler saw no {kernel} kernel")


def k6_alone(torch, cs, _lattice):
    """K6's device microseconds a step at phase 2's held steps, and the
    back-substitution's at each case's j_f."""
    import numpy as np

    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops.gmres_step import (
        arnoldi_state, arnoldi_step, backsolve)

    dev = torch.device("cuda", 0)
    cases = (("bench c64", "complex64", 48, (0, 7, 47)),
             ("offset table c128", "complex128", 192, (0, 10, 20)),
             ("cold rung c64", "complex64", cs.COLD_RESTART, (0, 580, 1161)))
    out = {}
    for label, name, m, js in cases:
        if label.startswith("cold"):
            c = create_from_branching_types("a")
            centers = cs.square_lattice(cs.N_SIDE_2D, 2)
            nb = len(centers)
            f32 = dict(dtype=torch.float32, device=dev)
            c64 = dict(dtype=torch.complex64, device=dev)
            ones, k1 = torch.ones(1, nb, **f32), torch.ones(1, **f32)
            mv, diag = _lattice.lattice_operator(c, 2, centers, ones, k1, k1,
                                                 torch.ones(1, nb, **c64),
                                                 torch.zeros(1, nb, **c64), stable=True)
            r = cs.randc(torch, np.random.default_rng(19), (1, nb * 3), torch.complex64, dev)
        else:
            mv, diag, r = cs.k6_operator(torch, dev, name, m)
        n_sys = r.shape[0]
        target = torch.zeros(n_sys, dtype=r.real.dtype, device=dev)
        tiny = float(torch.finfo(r.real.dtype).tiny) ** 0.5
        st = arnoldi_state(r, diag, target, m)
        row = {}
        for j in range(max(js) + 1):
            w = mv(st.V[:, j])
            if j in js:
                scratch = type(st)(*[t.clone() if isinstance(t, torch.Tensor) else t
                                     for t in st])
                row[f"step {j} us"] = round(k6_us_per_call(
                    torch, lambda: arnoldi_step(scratch, w, j, target, tiny), "k6_"), 3)
                del scratch
            arnoldi_step(st, w, j, target, tiny)
        j_f = int(st.flag[2])
        row[f"backsolve j_f={j_f} us"] = round(k6_us_per_call(
            torch, lambda: backsolve(st.R, st.g, st.flag, tiny), "k6_backsolve"), 3)
        out[label] = row
        del st, mv, diag, r
        torch.cuda.empty_cache()
    return out


def main():
    import torch

    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch.biem import _core, _lattice
    from biem_helmholtz_sphere_tpu_torch.ops import gmres

    if not torch.cuda.is_available():
        print("torch_k6_ab: CUDA is not available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if not args or args[0].startswith("--"):
        print(__doc__, file=sys.stderr)
        return 2
    lags = ()
    if "--lags" in args:
        lags = tuple(int(v) for v in args[args.index("--lags") + 1].split(","))
        if not hasattr(gmres, "_LAG_CUDA"):
            print("torch_k6_ab: this tree's GMRES has no lag; --lags skipped", file=sys.stderr)
            lags = ()
    print(f"card: {card_line()}", flush=True)
    warm_up(torch)
    out = {"lag": getattr(gmres, "_LAG_CUDA", None)}
    out["bench"] = bench(torch, cs, _core)
    out["cold rung"] = cold_rung(torch, cs, _core, _lattice, gmres.gmres_solve_op)
    out["4D"] = four_d_gmres(torch, cs, _core)
    out["K6 alone"] = k6_alone(torch, cs, _lattice)
    counters = ("host_reads", "steps_issued", "steps_run")
    out["by lag"] = []
    for lag in lags:
        gmres._LAG_CUDA = lag
        before = [getattr(gmres.gmres_solve_op, k) for k in counters]
        row = {"lag": lag, "bench": bench(torch, cs, _core)}
        # bench() runs 1 + 3 + 1 + 1 sweeps of 2 solves each
        row["per bench solve"] = {k: round((getattr(gmres.gmres_solve_op, k) - b) / 12, 3)
                                  for k, b in zip(counters, before)}
        row["cold rung"] = cold_rung(torch, cs, _core, _lattice, gmres.gmres_solve_op)
        out["by lag"].append(row)
    print(sys.argv[1], json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
