"""The coax tables' cold build, split by stage, on one card.

    python tools/torch_ku_ab.py LABEL [--warm-ku] [--trace-ku]

Run from the repository root on a machine with a CUDA card and nvcc (no
JAX needed).  In this fresh process, after a warm-up
(`ab_common.warm_up`: the kernels built and loaded, a small 'ba' solve),
it times with synchronising host timers
(`chip_smoke.split_stages`):

- phase 8 (a)'s first block, cold: 'bba' on the hypercube {-2, 2}^4,
  n_end = 20, complex64, the first 4 k of the 4D sweep, solver auto (the
  factored GMRES), `basis` at n_end warm as in chip_smoke.py; split into
  RHS, radial rows, coax and, of the coax, its tables and K5 (K2 is the
  rest: `coax_fold` counts its launches through its module's name, so it
  is not wrapped), D's build, GMRES, uscat(0);
- the float32 coax tables (those of the complex64 path) of 'ba' at
  n_end = 32 (the bench) and 64, built cold (`basis` at n_end warm);
- KU alone (`coax_u`) at chip_smoke.py phase 2's timed cases, (i) 'bba'
  n_end = 20, (ii) 'ba' 32, (iii) 'ba' 64 and (iv) 'bbba' 8, both table
  dtypes: the device microseconds per call of its kernels (torch.profiler,
  every kernel whose name holds "coax_u_") and the milliseconds around the
  wrapper (CUDA events, median of 5).

With --warm-ku the warm-up also launches KU once in each table dtype
(the 'ba' tables at n_end = 8), so that every kernel KU's cases launch is
loaded before the first block: the first block's KU stage then holds no
first-launch cost (with lazy module loading, CUDA's default, each kernel
is loaded at its first launch; CUDA_MODULE_LOADING=EAGER in the
environment loads them all with the library instead).  With --trace-ku
the first block's KU call runs under torch.profiler (host and device
activities) and its 15 costliest events by own host time are printed
(where a first call's milliseconds go: allocations, attribute calls,
launches).

The tables are split by whatever stages the tree under test has: the host
index and plan, the root tables on the card and KU (`_coax_plan_on`,
`_coax_tables_on`, `coax_u`), or the host numpy tables (`_coax_tables`,
which enumerate the basis at 2 n_end - 1) and, the rest of
`_coax_packed_on`, the host product, mask, tile fill and copies.  To time
the parent's in turns with this tree's (parent, this, this, parent):
`python tools/ab_common.py PARENT_DIR tools/torch_ku_ab.py`.  Prints the
card, then LABEL and one JSON object of seconds.
"""

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.ab_common import card_line, warm_up  # noqa: E402


def stages_of(mods):
    """The (module, attribute, label) stages that exist in this tree."""
    _core, _scaled = mods
    cand = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows_scaled", "radial rows"),
            (_core, "coax_fold_packed", "coax"),
            (_scaled, "_coax_packed_on", "coax tables"),
            (_scaled, "_coax_plan_on", "host index and plan"),
            (_scaled, "_coax_tables_on", "root tables on the card"),
            (_scaled, "coax_u", "KU"),
            (_scaled, "_coax_tables", "host numpy tables"),
            (_scaled, "spherical_h_scaled", "K5"),
            (_core, "rotation_d", "D build"), (_core, "gmres_solve_op", "GMRES"),
            (_core.BIEMResultCalculator, "uscat", "uscat(0)")]
    return [s for s in cand if hasattr(s[0], s[1])]


def ku_alone(torch, cs, dev):
    """{case: {dtype: [device us per call, ms around the wrapper]}} of KU at
    chip_smoke.py's timed KU cases."""
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops.coax_u import coax_u
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import _coax_tables_on
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import _coax_plan_on

    out = {}
    for label, tree, n_end, timed in cs.KU_CASES:
        if not timed:
            continue
        c = create_from_branching_types(tree)
        layout, plan = _coax_plan_on(c, n_end, dev)[:2]
        tables = _coax_tables_on(c, n_end, dev)
        row = {}
        for rdt in (torch.float32, torch.float64):
            def fn(rdt=rdt):
                return coax_u(tables, layout, plan, rdt)

            row[str(rdt).split(".")[-1]] = [
                round(cs.device_us(torch, fn, "coax_u_", per_call=True), 2),
                round(cs.cuda_ms(torch, fn, 5), 4)]
        out[f"{label}, n_end={n_end}"] = row
        del tables, layout, plan
        torch.cuda.empty_cache()
    return out


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.biem import _core
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.translation import _scaled

    if not torch.cuda.is_available():
        print("torch_ku_ab: CUDA is not available", file=sys.stderr)
        return 2
    flags = sys.argv[2:]
    if len(sys.argv) < 2 or not set(flags) <= {"--warm-ku", "--trace-ku"}:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    f = dict(dtype=torch.float32, device=dev)

    def solve(tree, ks, centers, n_end):
        kt = torch.as_tensor(np.asarray(ks), **f)
        n_k, d = kt.numel(), tree.c_ndim
        direction = torch.zeros(d, n_k, **f)
        direction[0] = 1.0
        uin, _ = plane_wave(k=kt, direction=direction)
        calc = biem(tree, centers=torch.as_tensor(centers, **f).expand(n_k, len(centers), d),
                    radii=torch.ones(n_k, len(centers), **f), k=kt, n_end=n_end, uin=uin)
        return calc.uscat(torch.zeros(d, 1, **f))

    print(f"card: {card_line()}", flush=True)
    warm_up(torch)
    if "--warm-ku" in flags:
        from biem_helmholtz_sphere_tpu_torch.ops.coax_u import coax_u
        from biem_helmholtz_sphere_tpu_torch.translation._rotation import _coax_tables_on

        c = create_from_branching_types("ba")
        layout, plan = _scaled._coax_plan_on(c, 8, dev)[:2]
        for rdt in (torch.float32, torch.float64):
            coax_u(_coax_tables_on(c, 8, dev), layout, plan, rdt)
        torch.cuda.synchronize()
    if "--trace-ku" in flags:
        traced, done = _scaled.coax_u, []

        def coax_u_traced(*a, **kw):
            if done:  # the first call only
                return traced(*a, **kw)
            done.append(1)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as p:
                out = traced(*a, **kw)
                torch.cuda.synchronize()
            print(p.key_averages().table(sort_by="self_cpu_time_total", row_limit=15),
                  flush=True)
            return out

        _scaled.coax_u = coax_u_traced
    stages = stages_of((_core, _scaled))
    out = {}
    c4 = create_from_branching_types("bba")
    basis(c4, cs.N_END_4D)
    acc, total = cs.split_stages(torch, lambda: solve(c4, cs.sweep_ks_4d()[:cs.KB],
                                                      cs.hypercube_centers(), cs.N_END_4D), stages)
    out["4D first block"] = dict({k: round(v, 6) for k, v in acc.items()}, total=round(total, 6))
    c3 = create_from_branching_types("ba")
    for n_end in (cs.N_END, 64):
        basis(c3, n_end)
        acc, total = cs.split_stages(
            torch, lambda: _scaled._coax_packed(c3, n_end, torch.float32, dev), stages)
        out[f"'ba' n_end={n_end} tables"] = dict({k: round(v, 6) for k, v in acc.items()},
                                                total=round(total, 6))
    out["KU alone"] = ku_alone(torch, cs, dev)
    out["module loading"] = os.environ.get("CUDA_MODULE_LOADING", "default (lazy)")
    out["warm-up"] = "+ KU in both dtypes" if "--warm-ku" in flags else "ab_common.warm_up"
    print(sys.argv[1], json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
