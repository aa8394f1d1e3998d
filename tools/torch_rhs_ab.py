"""The bench sweep's right-hand side and its per-block host work ("other")
on the card, timed in one process.

    python tools/torch_rhs_ab.py LABEL [--host-only]

Run from the repository root on a machine with a CUDA card and nvcc (no
JAX needed).  In this fresh process, after a warm-up (the kernels built
and loaded, a small 'ba' solve), it measures on the bench sweep
(`chip_smoke.bench_sweep`: 16 unit spheres, n_end=32, complex64, 8 k in
two warm-started blocks of 4), once run to warm its caches:

- the wall seconds per k of an untimed sweep (3 runs);
- the stage split per k (`chip_smoke.split_stages`, synchronising timers):
  phase 4's stages (RHS, radial rows, K2 with its K5, the solve, uscat(0))
  and, out of what phase 4 calls "other", the input checks
  (`_check_biem_inputs`), the route (`_route`), the pair routing
  (`_pair_routing`), KC's tables (`make_route`) and D's lookup
  (`rotation_d`); "other" is what is left;
- the same split with the operator's build as one stage (`_matfree_operator`
  beside the RHS, the solve, uscat(0), the input checks and the route);
- the device's idle share over a sweep under torch.profiler;
- the device microseconds of the RHS stage's kernels over one warm block
  (torch.profiler), by kernel name;
- the host microseconds per call, back to back up to one synchronize
  (`other_host_times`): the RHS stage (`_rhs_dispatch`) of a block, the
  bench geometry's `_pair_routing` and `make_route`, the whole factored
  operator's build (`_factored_operator`, its kernels enqueued), the input
  checks and the geometry read (`centers.detach().cpu()`);
- the host functions of a warm sweep under cProfile, the 25 with the most
  own time;
- KR alone (`plane_wave_rhs`) at the bench block's arguments
  (chip_smoke.kr_case, both dtypes): the device microseconds per launch
  (torch.profiler) of a warm call (the same direction as the last), of a
  call whose direction differs from the last one's, and of a cold call
  (the kept table and launch packs dropped, where the tree has them), the
  milliseconds around the wrapper (CUDA events) and its host microseconds
  per call.

With --host-only it prints only the last (tools/torch_profile_sweep.py
--host-only prints them too).  To time the parent's in turns with this
tree's (parent, this, this, parent, each a fresh process):

    python tools/ab_common.py PARENT_DIR tools/torch_rhs_ab.py

Prints the card, then LABEL and one JSON object.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.ab_common import busy_us, card_line, device_events, warm_up  # noqa: E402


def _host_us(torch, fn, reps):
    """Host microseconds per call of fn(), back to back up to one final
    synchronize, after 5 calls to warm it."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def bench_inputs(torch, dev):
    """The bench block's inputs as `biem()` hands them on: (c, centers_np,
    centers [B, d], radii, k, eta, alpha, beta [K, B] / [K], uin)."""
    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch import plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    f = dict(dtype=torch.float32, device=dev)
    centers_np = cs.lattice_centers()
    nb = len(centers_np)
    k = torch.as_tensor(cs.sweep_ks()[: cs.KB], **f)
    uin, _ = plane_wave(k=k, direction=torch.tensor([1.0, 0.0, 0.0], **f)[:, None].expand(3, cs.KB))
    return (create_from_branching_types("ba"), centers_np, torch.as_tensor(centers_np, **f),
            torch.ones(cs.KB, nb, **f), k, torch.ones(cs.KB, **f),
            torch.ones(cs.KB, nb, dtype=torch.complex64, device=dev),
            torch.zeros(cs.KB, nb, dtype=torch.complex64, device=dev), uin)


def other_host_times(torch, dev):
    """{row: host us per call} of the RHS stage and of the per-block host
    work around it, at the bench block's shapes."""
    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch.biem import _core

    c, centers_np, centers, radii, k, eta, alpha, beta, uin = bench_inputs(torch, dev)
    n_end, nb = cs.N_END, len(centers_np)

    def routing():
        rt = _core._pair_routing(centers_np)
        return _core.make_route(rt.src, rt.dst, rt.dn, nb, dev)

    rows = {
        f"RHS stage (_rhs_dispatch), {cs.KB} k x {nb} spheres": (
            lambda: _core._rhs_dispatch(c, n_end, centers, radii, alpha, beta, uin, None,
                                        (cs.KB,)), 200),
        "the bench geometry's _pair_routing + make_route": (routing, 50),
        "_factored_operator (its kernels enqueued)": (
            lambda: _core._factored_operator(c, n_end, centers_np, radii, k, eta, alpha, beta),
            50),
        "_check_biem_inputs": (
            lambda: _core._check_biem_inputs(c, centers.expand(cs.KB, -1, -1), radii, k, None,
                                             1.0, 0.0), 200),
        "centers.detach().cpu() (the geometry read)": (
            lambda: centers.expand(cs.KB, -1, -1).detach().cpu(), 200),
    }
    if hasattr(_core, "_factored_geometry"):  # the cached tables' lookup
        rows["_factored_geometry (cached lookup)"] = (
            lambda: _core._factored_geometry(*_core._geometry_key(centers_np), torch.float32,
                                             dev), 2000)
    return {label: round(_host_us(torch, fn, reps), 2) for label, (fn, reps) in rows.items()}


def rhs_device_us(torch, block, ks):
    """{kernel name: device us} of the RHS stage of one warm block."""
    from torch.profiler import ProfilerActivity, profile

    from biem_helmholtz_sphere_tpu_torch.biem import _core

    rhs = _core._rhs_dispatch
    found = {}

    def profiled(*args, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = rhs(*args, **kw)
            torch.cuda.synchronize()
        for e in device_events(prof):
            key = e.name[:60]
            found[key] = round(found.get(key, 0.0) + e.time_range.end - e.time_range.start, 2)
        return out

    _core._rhs_dispatch = profiled
    try:
        block(ks[:4], None)
    finally:
        _core._rhs_dispatch = rhs
    return found


def bench(torch, cs, _core):
    """The bench sweep's wall per k, finer stage split per k and idle
    share, and the RHS stage's kernels."""
    from torch.profiler import ProfilerActivity, profile

    block, sweep, ks = cs.bench_sweep(torch, torch.device("cuda", 0))
    n_k = len(ks)
    sweep()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    stages = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows_scaled", "radial rows"),
              (_core, "coax_fold_packed", "K2 (with its K5)"), (_core, "gmres_solve_op", "solve"),
              (_core.BIEMResultCalculator, "uscat", "uscat(0)"),
              (_core, "_check_biem_inputs", "input checks"), (_core, "_route", "route"),
              (_core, "_pair_routing", "pair routing"), (_core, "make_route", "KC tables"),
              (_core, "rotation_d", "D lookup")]
    acc, total = cs.split_stages(torch, sweep, stages)
    split = {k: round(v / n_k, 6) for k, v in acc.items()}
    split["other"] = round((total - sum(acc.values())) / n_k, 6)
    split["total"] = round(total / n_k, 6)
    # the operator's build as one stage: its glue is what the first split's
    # stages inside it leave
    outer = [(_core, "_rhs_dispatch", "RHS"), (_core, "_matfree_operator", "operator build"),
             (_core, "gmres_solve_op", "solve"), (_core.BIEMResultCalculator, "uscat", "uscat(0)"),
             (_core, "_check_biem_inputs", "input checks"), (_core, "_route", "route")]
    acc, total = cs.split_stages(torch, sweep, outer)
    split_outer = {k: round(v / n_k, 6) for k, v in acc.items()}
    split_outer["other"] = round((total - sum(acc.values())) / n_k, 6)
    split_outer["total"] = round(total / n_k, 6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle = 1.0 - busy_us(prof)[0] * 1e-6 / wall
    return {"per_k_s": round(min(walls) / n_k, 6),
            "per_k_s_runs": [round(w / n_k, 6) for w in walls], "split_per_k": split,
            "split_outer_per_k": split_outer, "idle_share": round(idle, 4),
            "rhs_stage_device_us": rhs_device_us(torch, block, ks),
            "host_profile_of_a_warm_sweep": host_profile(torch, sweep)}


def host_profile(torch, sweep, top=25):
    """The functions of a warm sweep under cProfile (its own cost on every
    Python call inflates them; the proportions are what it tells): the
    `top` by own time, as "file:line(name)": [calls, own ms, cumulative
    ms]."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    sweep()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {f"{Path(f).name}:{line}({name})": [nc, round(tt * 1e3, 3), round(ct * 1e3, 3)]
            for (f, line, name), (_, nc, tt, ct, _) in rows}


def kr_alone(torch, cs, dev):
    """{dtype: {row: value}} of KR alone at the bench block's arguments."""
    from biem_helmholtz_sphere_tpu_torch.ops import plane_rhs

    out = {}
    for cdt in (torch.complex64, torch.complex128):
        args = cs.kr_case(torch, dev, cdt, "ba", cs.N_END, cs.lattice_centers(), cs.KB, False)
        turned = list(args)
        turned[5] = args[5] * 0.8 + torch.roll(args[5], 1, dims=0) * 0.6
        turned[5] = turned[5] / torch.linalg.vector_norm(turned[5], dim=0, keepdim=True)
        flip, state = [args, turned], [0]

        def warm():
            return plane_rhs.plane_wave_rhs(*args)

        def changing():
            state[0] ^= 1
            return plane_rhs.plane_wave_rhs(*flip[state[0]])

        def cold():
            if hasattr(plane_rhs, "kr_table"):
                plane_rhs.kr_table.cache_clear()
                plane_rhs._packs.clear()
            return plane_rhs.plane_wave_rhs(*args)

        out[str(cdt).split(".")[-1]] = {
            "device us, warm": round(cs.device_us(torch, warm, "plane_rhs_kernel"), 2),
            "device us, direction changed": round(
                cs.device_us(torch, changing, "plane_rhs_kernel"), 2),
            "device us, cold": round(cs.device_us(torch, cold, "plane_rhs_kernel"), 2),
            "ms around the wrapper, warm": round(cs.cuda_ms(torch, warm, 20), 4),
            "host us per call, warm": round(_host_us(torch, warm, 200), 2)}
    return out


def main():
    import torch

    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch.biem import _core

    if not torch.cuda.is_available():
        print("torch_rhs_ab: CUDA is not available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if not args or args[0].startswith("--"):
        print(__doc__, file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    warm_up(torch)
    out = {}
    if "--host-only" not in args:
        out["bench"] = bench(torch, cs, _core)
    out["host us per call"] = other_host_times(torch, torch.device("cuda", 0))
    out["KR alone"] = kr_alone(torch, cs, torch.device("cuda", 0))
    print(args[0], json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
