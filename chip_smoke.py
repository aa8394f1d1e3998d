"""Drive the PyTorch/CUDA port of the solver once on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc
and no JAX.  Phases (each prints its lines; any failure raises and exits
non-zero before the result line):

0. require CUDA; print the card's name and power limit (nvidia-smi);
1. build the CUDA kernels from biem_helmholtz_sphere_tpu_torch/csrc;
2. hold each kernel against its plain PyTorch version on the card at the
   bench shapes, in complex64 and complex128, and time both;
3. the README golden (two unit spheres, k=1, n_end=6) through the port in
   complex128, to 6 decimal places;
4. the bench configuration (16 unit spheres on a 4x4 lattice, n_end=32,
   complex64, two k-blocks of 4 with warm starts) through `biem()`:
   launch counts of every kernel, GMRES residuals, uscat(0) against the
   committed float64 golden of the JAX package, the sound-soft boundary
   residual, a bit-for-bit repeat of the sweep, and uscat throughput.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_END = 32
N_SIDE = 4
SPACING = 4.0
KB = 4
K0 = 8.0
EVAL_POINTS = 1 << 17
GOLDEN_README = (-0.741333, -0.669657)
TOL_REL = {"complex64": 1e-4, "complex128": 1e-10}


def lattice_centers(n_side=N_SIDE, spacing=SPACING):
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, 3))
    centers[:, 0] = xx.ravel()
    centers[:, 1] = yy.ravel()
    return centers


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(torch, got, ref, mask=None):
    d = (got - ref).abs()
    r = ref.abs()
    if mask is not None:
        d, r = d[mask], r[mask]
    if not bool(torch.isfinite(d).all()):
        raise RuntimeError("kernel output is not finite")
    return float(d.max()), float(d.max() / r.max())


def randc(torch, rng, shape, dtype, dev):
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return torch.as_tensor(z, dtype=dtype, device=dev)


def check_kernels(torch, dev, card):
    """Phase 2: each kernel against its plain version at the bench shapes."""
    from biem_helmholtz_sphere_tpu_torch.biem._core import (
        _child_state_blocks, _pair_routing)
    from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import (
        _fused_ba_eval_plain, fused_ba_eval, regroup)
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
        _block_diag_cmm_plain, block_diag_cmm, pack, unpack)
    from biem_helmholtz_sphere_tpu_torch.ops.lane_route import (
        _lane_gather_plain, _lane_scatter_plain, lane_gather, lane_scatter,
        make_route)

    c = create_from_branching_types("ba")
    n_root = basis(c, N_END).n_root
    h = len(n_root)
    centers_np = lattice_centers()
    nb = len(centers_np)
    routing = _pair_routing(centers_np)
    n_slots, n_rad = len(routing.uniq), len(routing.uniq_r)
    lps = 2 * routing.p_max
    cs_sizes, cs_perm = _child_state_blocks(c, N_END)
    results = {}
    for cdt in (torch.complex64, torch.complex128):
        name = str(cdt).split(".")[-1]
        rdt = torch.float32 if cdt == torch.complex64 else torch.float64
        rng = np.random.default_rng(1234)
        tol = TOL_REL[name]

        # KB: D^H, X (permuted child-state blocks), D on the bench lanes
        d_bd = pack(torch.zeros((n_slots, h, h), dtype=cdt, device=dev),
                    2 * np.arange(N_END) + 1)
        d_bd = replace(d_bd, vals=randc(torch, rng, d_bd.vals.shape, cdt, dev))
        x_bd = pack(torch.zeros((KB, n_rad, h, h), dtype=cdt, device=dev),
                    cs_sizes, cs_perm)
        x_bd = replace(x_bd, vals=randc(torch, rng, x_bd.vals.shape, cdt, dev))
        d_dense, x_dense = unpack(d_bd), unpack(x_bd)
        lanes = randc(torch, rng, (KB, n_slots, lps, h), cdt, dev)
        lanes_x = lanes.reshape(KB, n_rad, -1, h)
        cases = [
            ("D^H", lambda: block_diag_cmm(d_bd, lanes, adjoint=True),
             lambda: _block_diag_cmm_plain(d_dense, lanes, True)),
            ("X", lambda: block_diag_cmm(x_bd, lanes_x),
             lambda: _block_diag_cmm_plain(x_dense, lanes_x, False)),
            ("D", lambda: block_diag_cmm(d_bd, lanes),
             lambda: _block_diag_cmm_plain(d_dense, lanes, False)),
        ]
        kb = {"ms": 0.0, "plain_ms": 0.0, "abs": 0.0, "rel": 0.0}
        for label, kfn, pfn in cases:
            ea, er = rel_err(torch, kfn(), pfn())
            ms, pms = cuda_ms(torch, kfn, 10), cuda_ms(torch, pfn, 5)
            print(f"[2] block_diag_cmm {label:3s} {name}: max_abs_err {ea:.3e} "
                  f"max_rel_err {er:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms ({card})")
            if er > tol:
                raise RuntimeError(f"block_diag_cmm {label} {name}: rel err {er:.3e} > {tol}")
            kb = {"ms": kb["ms"] + ms, "plain_ms": kb["plain_ms"] + pms,
                  "abs": max(kb["abs"], ea), "rel": max(kb["rel"], er)}
        results.setdefault("block_diag_cmm", {})[name] = kb

        # KC: gather and scatter with the bench routing
        route = make_route(routing.src, routing.dst, routing.p_max, nb, dev)
        pm = torch.as_tensor((-1.0) ** (n_root % 2), dtype=rdt, device=dev)
        xv, blc, diag, reg = (randc(torch, rng, (KB, nb, h), cdt, dev) for _ in range(4))
        y = randc(torch, rng, (KB, len(routing.src), h), cdt, dev)
        for kname, kfn, pfn in (
            ("lane_gather", lambda: lane_gather(xv, blc, pm, route),
             lambda: _lane_gather_plain(xv, blc, pm, route)),
            ("lane_scatter", lambda: lane_scatter(y, xv, diag, reg, pm, route),
             lambda: _lane_scatter_plain(y, xv, diag, reg, pm, route)),
        ):
            ea, er = rel_err(torch, kfn(), pfn())
            ms, pms = cuda_ms(torch, kfn, 20), cuda_ms(torch, pfn, 20)
            print(f"[2] {kname} {name}: max_abs_err {ea:.3e} max_rel_err {er:.3e} "
                  f"kernel {ms:.4f} ms plain {pms:.4f} ms ({card})")
            if er > tol:
                raise RuntimeError(f"{kname} {name}: rel err {er:.3e} > {tol}")
            results.setdefault(kname, {})[name] = {"ms": ms, "plain_ms": pms,
                                                   "abs": ea, "rel": er}

        # KA: near field at 131072 points (k=8) and uscat(0) for a k-block
        ell = torch.as_tensor(n_root, device=dev)
        w = randc(torch, rng, (1, nb, h), cdt, dev) * torch.exp(-ell.to(rdt))
        w2 = regroup(c, N_END, w)
        cen = torch.as_tensor(centers_np, dtype=rdt, device=dev)
        pts = torch.as_tensor(
            np.random.default_rng(0).normal(size=(3, EVAL_POINTS)) * 20.0,
            dtype=rdt, device=dev,
        )[:, None, :]
        k1 = torch.full((1,), K0, dtype=rdt, device=dev)
        outside = (torch.linalg.vector_norm(
            pts[:, 0, :, None] - cen.T[:, None, :], dim=0) > 1.0).all(-1)
        ka = fused_ba_eval(pts, cen, k1, w2)
        ea, er = rel_err(torch, ka[:, 0], _fused_ba_eval_plain(pts, cen, k1, w2, False, False)[:, 0], outside)
        ms = cuda_ms(torch, lambda: fused_ba_eval(pts, cen, k1, w2), 10)
        pms = cuda_ms(torch, lambda: _fused_ba_eval_plain(pts, cen, k1, w2, False, False), 3)
        print(f"[2] fused_ba_eval near {EVAL_POINTS} pts {name}: max_abs_err {ea:.3e} "
              f"max_rel_err {er:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms ({card})")
        if er > tol:
            raise RuntimeError(f"fused_ba_eval {name}: rel err {er:.3e} > {tol}")
        results.setdefault("fused_ba_eval", {})[name] = {"ms": ms, "plain_ms": pms,
                                                         "abs": ea, "rel": er}
        kb4 = torch.linspace(7.0, 7.06, KB, dtype=rdt, device=dev)
        w2b = regroup(c, N_END, randc(torch, rng, (KB, nb, h), cdt, dev)
                      * torch.exp(-ell.to(rdt)))
        zero = torch.zeros((3, 1, 1), dtype=rdt, device=dev)
        for far in (False, True):
            ea, er = rel_err(torch, fused_ba_eval(zero, cen, kb4, w2b, far=far),
                             _fused_ba_eval_plain(zero, cen, kb4, w2b, far, False))
            print(f"[2] fused_ba_eval {'far' if far else 'near'} 1 pt x K={KB} {name}: "
                  f"max_abs_err {ea:.3e} max_rel_err {er:.3e}")
            if er > tol:
                raise RuntimeError(f"fused_ba_eval K={KB} {name}: rel err {er:.3e} > {tol}")
    return results


def readme_golden(torch, dev):
    """Phase 3: the README problem through the port on the card."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    c = create_from_branching_types("ba")
    vals = {}
    for rdt in (torch.float64, torch.float32):
        f = dict(dtype=rdt, device=dev)
        uin, _ = plane_wave(k=torch.tensor(1.0, **f),
                            direction=torch.tensor([1.0, 0.0, 0.0], **f))
        calc = biem(c, centers=torch.tensor([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]], **f),
                    radii=torch.ones(2, **f), k=torch.tensor(1.0, **f), n_end=6,
                    uin=uin, solver="matfree", stable=True)
        vals[rdt] = complex(calc.uscat(torch.zeros(3, 1, **f))[0])
    u = vals[torch.float64]
    print(f"[3] README golden complex128 uscat(0) = {u.real:.6f}{u.imag:+.6f}j "
          f"(complex64 {vals[torch.float32]:.6f})")
    if (round(u.real, 6), round(u.imag, 6)) != GOLDEN_README:
        raise RuntimeError(f"README golden mismatch: {u} vs {GOLDEN_README}")


def bench_config(torch, dev, card):
    """Phase 4: the bench configuration through biem(); returns launches."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import fused_ba_eval
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import block_diag_cmm
    from biem_helmholtz_sphere_tpu_torch.ops.lane_route import lane_gather, lane_scatter

    wrappers = {"fused_ba_eval": fused_ba_eval, "block_diag_cmm": block_diag_cmm,
                "lane_gather": lane_gather, "lane_scatter": lane_scatter}
    c = create_from_branching_types("ba")
    f = dict(dtype=torch.float32, device=dev)
    centers_np = lattice_centers()
    nb = len(centers_np)
    centers = torch.as_tensor(centers_np, **f)
    direction = torch.tensor([1.0, 0.0, 0.0], **f)
    ks = np.linspace(7.0, 9.0, 100).astype(np.float32)[: 2 * KB]

    def block(kb, dens0):
        kt = torch.as_tensor(kb, **f)
        uin, _ = plane_wave(k=kt, direction=direction[:, None].expand(3, KB))
        calc = biem(c, centers=centers.expand(KB, nb, 3), radii=torch.ones(KB, nb, **f),
                    k=kt, n_end=N_END, uin=uin, density0=dens0)
        return calc, calc.uscat(torch.zeros(3, 1, **f))[0]

    def sweep():
        dens = torch.zeros((nb, N_END * N_END), dtype=torch.complex64, device=dev)
        out = []
        for i0 in range(0, len(ks), KB):
            calc, u0 = block(ks[i0 : i0 + KB], dens)
            dens = calc.density[KB - 1]
            out.append((calc, u0))
        return out

    block(ks[:KB] - 0.5, None)  # warm-up block: caches, allocator, kernel load
    torch.cuda.synchronize()
    for wrap in wrappers.values():
        wrap.launches = 0
    t0 = time.perf_counter()
    run1 = sweep()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: wrap.launches for name, wrap in wrappers.items()}
    print(f"[4] launches in the sweep: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"the main path never launched {name}")

    iters = [calc.iters.tolist() for calc, _ in run1]
    relres = [calc.relres.tolist() for calc, _ in run1]
    for calc, _ in run1:
        if not bool(torch.isfinite(calc.density).all()):
            raise RuntimeError("non-finite density")
    worst = max(max(r) for r in relres)
    print(f"[4] GMRES iters per system {iters}, max relres {worst:.3e}")
    if worst > 3e-5:
        raise RuntimeError(f"relres {worst:.3e} > 3e-5")
    iters_per_k = float(np.mean([max(i) for i in iters]))
    print(f"[4] per-k {dt / len(ks):.6f} s over {len(ks)} k ({len(ks) // KB} blocks "
          f"of {KB}, warm starts), GMRES iters per k {iters_per_k} ({card})")

    with open(os.path.join(ROOT, "biem_helmholtz_sphere_tpu_torch", "data",
                           "bench_golden_f64.json")) as fh:
        golden = json.load(fh)["points"]
    u_first = run1[0][1].cpu().numpy()
    for i, g in enumerate(golden[:KB]):
        if abs(g["k"] - float(ks[i])) > 1e-6:
            raise RuntimeError(f"golden k {g['k']} != sweep k {ks[i]}")
        ref = complex(*g["uscat0"])
        err = abs(u_first[i] - ref) / abs(ref)
        print(f"[4] k={ks[i]:.6f} uscat(0) = {u_first[i]:.6f} golden {ref:.6f} rel err {err:.2e}")
        if err > 1e-3:
            raise RuntimeError(f"uscat(0) at k={ks[i]} off the JAX f64 golden by {err:.2e}")

    rng = np.random.default_rng(7)
    pts = []
    for b in (0, 5, 10, 15):
        v = rng.normal(size=(3, 64))
        v /= np.linalg.norm(v, axis=0)
        pts.append(centers_np[b][:, None] + 1.0000005 * v)
    xb = torch.as_tensor(np.concatenate(pts, axis=1), **f)
    calc0 = run1[0][0]
    res = (torch.exp(1j * calc0.k[None, :] * xb[0][:, None]) + calc0.uscat(xb)).abs()
    res_max = float(res.max())
    print(f"[4] sound-soft BC residual at 256 points on spheres 0,5,10,15: "
          f"max {res_max:.3e} mean {float(res.mean()):.3e}")
    if not res_max <= 1e-3:
        raise RuntimeError(f"BC residual {res_max:.3e} > 1e-3")

    run2 = sweep()
    torch.cuda.synchronize()
    same = all(
        torch.equal(torch.view_as_real(a[1]), torch.view_as_real(b[1]))
        and torch.equal(torch.view_as_real(a[0].density), torch.view_as_real(b[0].density))
        for a, b in zip(run1, run2)
    )
    print(f"[4] repeated sweep bit-for-bit equal: {same}")
    if not same:
        raise RuntimeError("the repeated sweep differs")

    uin, _ = plane_wave(k=torch.tensor(K0, **f), direction=direction)
    calc = biem(c, centers=centers, radii=torch.ones(nb, **f), k=torch.tensor(K0, **f),
                n_end=N_END, uin=uin)
    x = torch.as_tensor(
        np.random.default_rng(0).normal(size=(3, EVAL_POINTS)).astype(np.float32) * 20.0,
        device=dev)
    calc.uscat(x)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        calc.uscat(x)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    print(f"[4] uscat throughput {EVAL_POINTS / best:.1f} pts/s "
          f"({EVAL_POINTS} points, best of 5: {best:.6f} s) ({card})")
    return launches


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from biem_helmholtz_sphere_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on")
    dev = torch.device("cuda", 0)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[0] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.library()
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({kernels.library_path().name})")

    results = check_kernels(torch, dev, card)
    readme_golden(torch, dev)
    launches = bench_config(torch, dev, card)

    sources = {
        "fused_ba_eval": ("csrc/fused_ba_eval.cu",
                          "biem_helmholtz_sphere_tpu/biem/_eval_fused.py:114"),
        "block_diag_cmm": ("csrc/block_diag_cmm.cu",
                           "biem_helmholtz_sphere_tpu/biem/_core.py:640"),
        "lane_gather": ("csrc/lane_route.cu",
                        "biem_helmholtz_sphere_tpu/biem/_core.py:632"),
        "lane_scatter": ("csrc/lane_route.cu",
                         "biem_helmholtz_sphere_tpu/biem/_core.py:647"),
    }
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": "biem_helmholtz_sphere_tpu_torch/" + src,
            "replaces": rep,
            "launches": launches[name],
            "max_abs_err": results[name]["complex64"]["abs"],
            "ms": results[name]["complex64"]["ms"],
            "plain_ms": results[name]["complex64"]["plain_ms"],
        }
        for name, (src, rep) in sources.items()
    ]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
