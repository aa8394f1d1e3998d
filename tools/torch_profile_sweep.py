"""Profile the port's bench sweep on the card: device time per kernel and
the device's idle share.

    python tools/torch_profile_sweep.py [--host-only | --4d | --lattice]

Run from the repository root on a machine with a CUDA card (no JAX
needed).  It drives chip_smoke.py's bench sweep (`chip_smoke.bench_sweep`: 16 unit
spheres on a 4x4 lattice, n_end=32, complex64, 8 k in blocks of 4 with
warm starts) once to warm up and once under torch.profiler, then prints:

- the card's name and power limit;
- the wall time of the profiled sweep and the device's busy time (the
  union of the intervals in which any kernel ran), hence its idle share;
- the device time of each kernel name, largest first, with its count, and
  that of the port's own kernels (csrc/), found by their CUDA names among
  the profiler's device events;
- the device time per launch of KB's three products (D^H, X, D) on the
  bench routing's compacted lanes, of KA in both of its modes (131,072
  points x 1 k, and 1 point x 4 k as uscat(0) runs it), of K5's three
  launch shapes of a k-block, of the KC gather and scatter and of K2 for
  a k-block (4 k x 9 radii), each profiled alone over 20 launches at the
  bench widths (complex64), of K2's zero-exponent mode (coaxial_sr's band
  sum, 4 k x 9 radii) at n_end 19 and 32 in both dtypes and of K5 at the
  point-source right-hand side's 137,280 points (chip_smoke.py phase 6
  (c)), and of KD for a k-block as chip_smoke.py phase 2 runs it
  (complex64 pair-major at n_end=32, complex128 [B, H, B', H'] at
  n_end=19, 5 launches each), and the modes chip_smoke.py phase 7 adds:
  KA with a complex k in both modes, KD with a pair map per k (four
  lattice pitches at n_end=19) and K5's base-2 (even d) mode at the 4D
  route's shapes (d = 4, n_end = 20); and, over all their kernels, the
  plain-torch stages it adds: the general field evaluation ('bpa', 131,072
  points, 1 k) and the cylinder seeds `cyl_jh01` (4 x 16 arguments);
- the host microseconds per call of the K5 wrapper in its three modes and
  of the KC gather and K2 wrappers at the same shapes, with a
  `torch.empty` and the stream queries beside them, and of the bench
  block's right-hand side and its per-block host work
  (tools/torch_rhs_ab.py's `other_host_times`: the RHS stage, the pair
  routing and KC's tables, the factored operator's build, the input
  checks, the geometry read) (only these with --host-only).

With --4d it profiles chip_smoke.py phase 8 (a)'s 4D path instead ('bba',
16 unit spheres at the corners of {-2, 2}^4, n_end=20, complex64, the
first 8 k of linspace(3.5, 4.5, 100) in two blocks of 4 with warm starts,
the factored GMRES with KB's row panels): the same wall, busy and idle
share and device time by kernel, then the device us per launch of KB's
row-panel D^H and D at those shapes alone.

With --lattice it profiles chip_smoke.py phase 9 (a)'s lattice-FFT route
('ba', 32 x 32 unit spheres at pitch 4, n_end=19, complex64, k = 1,
solver="auto"): a first solve builds the geometry's tables, the second
solve with uscat(0) runs under the profiler (the same wall, busy and idle
share and device time by kernel); then the device us per launch, each
alone, of KG at phase 9 (b)'s n_end=32 table (8,064 offsets x 63 x 63,
the fold mode), and of the lattice matvec's forward FFT, per-frequency
product (`torch.matmul`) and inverse FFT at (a)'s and (b)'s n_end=32
shapes.

Copied with chip_smoke.py into an unpacked parent (its `tools/` and its
root), it times the parent's kernels and wrappers: run both copies in one
call, in turns, to compare them.

Numbers from a profiled run include the profiler's own overhead on the
host; compare device times, not the wall time, with unprofiled runs.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.ab_common import busy_us, card_line, device_events  # noqa: E402


def _device_time(evt):
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


# the __global__ functions of csrc/*.cu, as their CUDA names contain them
PORT_KERNELS = ("fused_ba_eval_kernel", "fused_ba_eval_few_kernel", "block_diag_cmm_kernel",
                "lane_gather_kernel", "lane_scatter_kernel", "spherical_jh_kernel",
                "coax_fold_kernel", "dense_assemble_kernel", "graf_fold_kernel", "band_f_kernel",
                "band_sr_kernel", "k6_arnoldi_step", "k6_backsolve", "coax_u_kernel",
                "coax_u_rows_kernel", "plane_rhs_kernel")


def _port_kernel_name(name):
    """The port kernel's instance (name and template arguments) a device
    event's CUDA name holds, or None."""
    for k in PORT_KERNELS:
        i = name.find(k + "<")
        if i < 0:
            i = name.find(k + "(")
        if i >= 0:
            j = name.find("(", i)
            return name[i : j if j > 0 else len(name)]
    return None


def _port_kernel_rows(prof):
    """{instance: (total us, launches)} of the port's kernels among the
    device events (not `key_averages()`, whose keys may be the host ops
    that launched them)."""
    rows = {}
    for e in device_events(prof):
        key = _port_kernel_name(e.name)
        if key is not None:
            t, n = rows.get(key, (0.0, 0))
            rows[key] = (t + e.time_range.end - e.time_range.start, n + 1)
    return rows


def _per_launch_us(torch, fn, reps=20):
    """Device microseconds per launch of the kernels fn() runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(t for t, _ in _port_kernel_rows(prof).values()) / reps


def _all_device_us(torch, fn, reps=3):
    """Device microseconds per call of fn(), over every kernel it runs (a
    stage in plain torch launches many)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in device_events(prof)) / reps


def plain_stage_device_times(torch, dev):
    """The plain-torch stages phase 7 adds, each alone: the general field
    evaluation ('bpa', 131,072 points, 1 k, at the bench) and the cylinder
    seeds of K5's base-2 mode (cyl_jh01 at 4 k x 16 arguments)."""
    import numpy as np

    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.special._cyl import cyl_jh01
    from chip_smoke import EVAL_POINTS, K0, KB, N_END, lattice_centers

    f = dict(dtype=torch.float32, device=dev)
    centers = torch.as_tensor(lattice_centers(), **f)
    k = torch.tensor(K0, **f)
    uin, _ = plane_wave(k=k, direction=torch.tensor([1.0, 0.0, 0.0], **f))
    calc = biem(create_from_branching_types("bpa"), centers=centers,
                radii=torch.ones(len(centers), **f), k=k, n_end=N_END, uin=uin)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(3, EVAL_POINTS)) * 20.0, **f)
    z = (torch.linspace(7.0, 7.06, KB, **f)[:, None] * torch.ones(len(centers), **f)).to(
        torch.complex64)
    return {
        f"general evaluation ('bpa', plain torch) {EVAL_POINTS} pts x 1 k, all its kernels":
            _all_device_us(torch, lambda: calc.uscat(x)),
        f"cyl_jh01 (plain torch) {KB} x {len(centers)} complex64, all its kernels":
            _all_device_us(torch, lambda: cyl_jh01(z), 10),
    }


def kernel_device_times(torch, dev):
    """KB per product, KA in both modes, K5 per launch shape and KC, each
    alone on the card."""
    from dataclasses import replace

    import numpy as np

    from biem_helmholtz_sphere_tpu_torch.biem._core import _pair_routing
    from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import fused_ba_eval, regroup
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics import basis
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
        LaneSegments, block_diag_cmm, pack)
    from biem_helmholtz_sphere_tpu_torch.ops.lane_route import (
        lane_gather, lane_scatter, make_route)
    from biem_helmholtz_sphere_tpu_torch.special._family import (
        _H_ONLY, _SCALED, _UNSCALED, spherical_jh)
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import (
        _child_state_blocks, coax_fold)
    from biem_helmholtz_sphere_tpu_torch.ops.dense import dense_assemble
    from biem_helmholtz_sphere_tpu_torch.harmonics._expand import _quad_harmonics
    from biem_helmholtz_sphere_tpu_torch.biem._core import _assembly_parts
    from chip_smoke import (
        EVAL_POINTS, KB, N_END, N_END_4D, N_END_LU, PITCHES, SOURCE, coax_args, coax_zero_args,
        dense_parts, lattice_centers)

    c = create_from_branching_types("ba")
    h = N_END * N_END
    cdt, rdt = torch.complex64, torch.float32
    rng = np.random.default_rng(5)

    def randc(shape):
        z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(z, dtype=cdt, device=dev)

    centers_np = lattice_centers()
    rt = _pair_routing(centers_np)
    n_slots, n_rad = len(rt.uniq), len(rt.uniq_r)
    d_bd = pack(torch.zeros((n_slots, h, h), dtype=cdt, device=dev), 2 * np.arange(N_END) + 1)
    d_bd = replace(d_bd, vals=randc(d_bd.vals.shape))
    x_bd = pack(torch.zeros((KB, n_rad, h, h), dtype=cdt, device=dev),
                *_child_state_blocks(c, N_END))
    x_bd = replace(x_bd, vals=randc(x_bd.vals.shape))
    lanes = randc((KB, len(rt.src), h))
    d_seg = LaneSegments(tuple(int(v) for v in rt.slot_ptr))
    x_seg = LaneSegments(tuple(int(v) for v in rt.rad_ptr))
    cen = torch.as_tensor(centers_np, dtype=rdt, device=dev)
    ell = torch.as_tensor(basis(c, N_END).n_root, device=dev)
    w1 = regroup(c, N_END, randc((1, len(centers_np), h)) * torch.exp(-ell.to(rdt)))
    w4 = regroup(c, N_END, randc((KB, len(centers_np), h)) * torch.exp(-ell.to(rdt)))
    pts = torch.as_tensor(rng.normal(size=(3, 1, EVAL_POINTS)) * 20.0, dtype=rdt, device=dev)
    zero = torch.zeros((3, 1, 1), dtype=rdt, device=dev)
    k1 = torch.full((1,), 8.0, dtype=rdt, device=dev)
    k4 = torch.linspace(7.0, 7.06, KB, dtype=rdt, device=dev)
    nb = len(centers_np)
    z_rows = (k4[:, None] * torch.ones(nb, dtype=rdt, device=dev)).to(cdt)
    z_coax = (k4[:, None] * torch.as_tensor(rt.uniq_r, dtype=rdt, device=dev)).to(cdt)
    route = make_route(rt.src, rt.dst, rt.dn, nb, dev)
    pm = ((-1.0) ** (ell % 2)).to(rdt)
    xv, blc, diag, reg = (randc((KB, nb, h)) for _ in range(4))
    k2 = coax_args(torch, dev, rdt)
    k2z = {}
    for zdt in (torch.float32, torch.float64):
        for n_z in (N_END_LU, N_END):
            zargs = coax_zero_args(torch, dev, zdt, n_z)
            k2z[f"coax_fold zero-exponent mode {KB} k x {n_rad} radii n_end {n_z} "
                f"{'complex64' if zdt == torch.float32 else 'complex128'}"] = _per_launch_us(
                torch, lambda: coax_fold(*zargs))
    # the point source's right-hand side: one order at Q x B x KB points
    xq = _quad_harmonics(c, N_END, 2 * N_END - 1, rdt, dev)[0][:, :, None] + cen.T[:, None, :]
    z_src = (k4 * torch.linalg.vector_norm(
        xq - torch.tensor(SOURCE, dtype=rdt, device=dev)[:, None, None], dim=0)[..., None]
             ).to(cdt)
    kd = {}
    # as chip_smoke.py phase 2: complex64 stable pair-major at the bench,
    # complex128 plain [B, H, B', H'] at the LU tier
    for label, kdt, n_kd, pair_major in (
            (f"dense_assemble {KB} k x {nb}x{nb} blocks n_end {N_END} complex64 pair-major",
             torch.float32, N_END, True),
            (f"dense_assemble {KB} k x {nb}x{nb} blocks n_end {N_END_LU} complex128 "
             "[B, H, B', H']", torch.float64, N_END_LU, False)):
        parts = dense_parts(torch, dev, kdt, n_kd, stable=pair_major)
        kd[label] = _per_launch_us(
            torch, lambda: dense_assemble(*parts, pair_major=pair_major), 5)
        del parts
        torch.cuda.empty_cache()
    # chip_smoke.py phase 7's kernel modes
    ck1 = (k1 + 0.1j).to(cdt)
    ck4 = (k4 + 0.1j).to(cdt)
    geo = torch.as_tensor(np.stack([lattice_centers(spacing=p) for p in PITCHES]), dtype=rdt,
                          device=dev)
    kd_parts = _assembly_parts(
        c, N_END_LU, geo.cpu().double().numpy(), torch.ones(KB, nb, dtype=rdt, device=dev),
        torch.full((KB,), 8.0, dtype=rdt, device=dev), torch.ones(KB, dtype=rdt, device=dev),
        torch.ones(KB, nb, dtype=cdt, device=dev), torch.zeros(KB, nb, dtype=cdt, device=dev),
        stable=True)
    phase7 = {
        f"fused_ba_eval {EVAL_POINTS} pts x 1 k, complex k": _per_launch_us(
            torch, lambda: fused_ba_eval(pts, cen, ck1, w1), 5),
        f"fused_ba_eval 1 pt x {KB} k, complex k, a geometry per k": _per_launch_us(
            torch, lambda: fused_ba_eval(zero, geo, ck4, w4)),
        f"dense_assemble a pair map per k, {KB} pitches x {nb}x{nb} blocks n_end {N_END_LU} "
        "complex64": _per_launch_us(torch, lambda: dense_assemble(*kd_parts), 5),
        f"spherical_jh base 2 (d = 4) h only {KB} k x {n_rad} distances x {2 * N_END_4D - 1}":
            _per_launch_us(torch, lambda: spherical_jh(_H_ONLY, 4, 2 * N_END_4D - 1, z_coax)),
        f"spherical_jh base 2 (d = 4) scaled {KB} k x {nb} radii x {N_END_4D}":
            _per_launch_us(torch, lambda: spherical_jh(_SCALED, 4, N_END_4D, z_rows)),
        f"spherical_jh base 2 (d = 4) unscaled {KB} k x {nb} radii x {N_END_4D}":
            _per_launch_us(torch, lambda: spherical_jh(_UNSCALED, 4, N_END_4D, z_rows)),
    }
    del kd_parts
    torch.cuda.empty_cache()
    return kd | phase7 | {
        "block_diag_cmm D^H": _per_launch_us(
            torch, lambda: block_diag_cmm(d_bd, lanes, d_seg, adjoint=True)),
        "block_diag_cmm X": _per_launch_us(torch, lambda: block_diag_cmm(x_bd, lanes, x_seg)),
        "block_diag_cmm D": _per_launch_us(torch, lambda: block_diag_cmm(d_bd, lanes, d_seg)),
        f"fused_ba_eval {EVAL_POINTS} pts x 1 k": _per_launch_us(
            torch, lambda: fused_ba_eval(pts, cen, k1, w1), 5),
        f"fused_ba_eval 1 pt x {KB} k": _per_launch_us(
            torch, lambda: fused_ba_eval(zero, cen, k4, w4)),
        f"spherical_jh scaled {KB} k x {nb} radii x {N_END}": _per_launch_us(
            torch, lambda: spherical_jh(_SCALED, 3, N_END, z_rows)),
        f"spherical_jh unscaled {KB} k x {nb} radii x {N_END}": _per_launch_us(
            torch, lambda: spherical_jh(_UNSCALED, 3, N_END, z_rows)),
        f"spherical_jh h only {KB} k x {len(rt.uniq_r)} distances x {2 * N_END - 1}":
            _per_launch_us(torch, lambda: spherical_jh(_H_ONLY, 3, 2 * N_END - 1, z_coax)),
        f"lane_gather {KB} k x {len(rt.src)} lanes": _per_launch_us(
            torch, lambda: lane_gather(xv, blc, pm, route)),
        f"lane_scatter {KB} k x {len(rt.src)} lanes": _per_launch_us(
            torch, lambda: lane_scatter(lanes, xv, diag, reg, pm, route)),
        f"coax_fold {KB} k x {n_rad} radii": _per_launch_us(torch, lambda: coax_fold(*k2)),
        f"spherical_jh unscaled 1 order at {z_src.numel()} points (point source)":
            _per_launch_us(torch, lambda: spherical_jh(_UNSCALED, 3, 1, z_src)),
    } | k2z


def _host_us(torch, fn, reps=2000):
    """Host microseconds per call of fn(), called back to back up to one
    final synchronize.  The kernels of these rows take less device time
    than their calls take to issue, so the row reads the host's time."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def wrapper_host_times(torch, dev):
    """K5 per mode, the KC gather and K2, each through its wrapper, on the
    host."""
    from biem_helmholtz_sphere_tpu_torch.biem._core import _pair_routing
    from biem_helmholtz_sphere_tpu_torch.ops import kernels
    from biem_helmholtz_sphere_tpu_torch.ops.lane_route import lane_gather, make_route
    from biem_helmholtz_sphere_tpu_torch.special._family import (
        _H_ONLY, _SCALED, _UNSCALED, spherical_jh)
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import coax_fold
    from chip_smoke import KB, N_END, coax_args, lattice_centers

    centers = lattice_centers()
    nb, h = len(centers), N_END * N_END
    rt = _pair_routing(centers)
    k4 = torch.linspace(7.0, 7.06, KB, device=dev)
    z_rows = (k4[:, None] * torch.ones(nb, device=dev)).to(torch.complex64)
    z_coax = (k4[:, None] * torch.as_tensor(rt.uniq_r, dtype=torch.float32,
                                            device=dev)).to(torch.complex64)
    route = make_route(rt.src, rt.dst, rt.dn, nb, dev)
    x, blc = (torch.randn(KB, nb, h, dtype=torch.complex64, device=dev) for _ in range(2))
    pm = torch.ones(h, device=dev)
    k2 = coax_args(torch, dev, torch.float32)
    rows = {
        f"spherical_jh scaled {KB} k x {nb} radii x {N_END}":
            lambda: spherical_jh(_SCALED, 3, N_END, z_rows),
        f"spherical_jh unscaled {KB} k x {nb} radii x {N_END}":
            lambda: spherical_jh(_UNSCALED, 3, N_END, z_rows),
        f"spherical_jh h only {KB} k x {len(rt.uniq_r)} distances x {2 * N_END - 1}":
            lambda: spherical_jh(_H_ONLY, 3, 2 * N_END - 1, z_coax),
        f"lane_gather {KB} k x {len(rt.src)} lanes": lambda: lane_gather(x, blc, pm, route),
        f"coax_fold {KB} k x {len(rt.uniq_r)} radii": lambda: coax_fold(*k2),
        f"torch.empty of {KB * nb * N_END} complex64": lambda: torch.empty(
            KB * nb * N_END, dtype=torch.complex64, device=dev),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
    }
    # the raw query kernels.launch makes, where the checkout has one
    if hasattr(kernels, "current_stream_handle"):
        rows["kernels.current_stream_handle()"] = kernels.current_stream_handle
    return {label: _host_us(torch, fn) for label, fn in rows.items()}


def _print_host_times(torch, dev):
    from tools.torch_rhs_ab import other_host_times

    print("host us per call (bench widths, complex64):")
    for label, us in (wrapper_host_times(torch, dev) | other_host_times(torch, dev)).items():
        print(f"  {us:9.2f} us  {label}")


def four_d_sweep(torch, dev):
    """(sweep, ks): chip_smoke.py phase 8 (a)'s 4D path over two blocks of
    KB k with warm starts."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from chip_smoke import KB, N_END_4D, hypercube_centers, sweep_ks_4d

    c = create_from_branching_types("bba")
    f = dict(dtype=torch.float32, device=dev)
    cube = torch.as_tensor(hypercube_centers(), **f)
    nb = cube.shape[0]
    direction = torch.zeros(4, KB, **f)
    direction[0] = 1.0
    ks = sweep_ks_4d()[: 2 * KB]

    def sweep():
        dens = None
        for i0 in range(0, len(ks), KB):
            kt = torch.as_tensor(ks[i0 : i0 + KB], **f)
            uin, _ = plane_wave(k=kt, direction=direction)
            calc = biem(c, centers=cube.expand(KB, nb, 4), radii=torch.ones(KB, nb, **f), k=kt,
                        n_end=N_END_4D, uin=uin, density0=dens)
            calc.uscat(torch.zeros(4, 1, **f))
            dens = calc.density[KB - 1]

    return sweep, ks


def four_d_kb_times(torch, dev):
    """Device us per launch of KB's row-panel D^H and D at the 4D path's
    shapes (random D with its degree blocks, the 240 compacted lanes)."""
    from dataclasses import replace

    import numpy as np

    from biem_helmholtz_sphere_tpu_torch.biem._core import _pair_routing
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import harm_n_ndim
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
        LaneSegments, block_diag_cmm, pack_layout)
    from chip_smoke import KB, N_END_4D, hypercube_centers

    rt = _pair_routing(hypercube_centers())
    sizes = [harm_n_ndim(n, 4) for n in range(N_END_4D)]
    h = sum(sizes)
    rng = np.random.default_rng(5)

    def randc(shape):
        z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(z, dtype=torch.complex64, device=dev)

    a = pack_layout(sizes, None, h, dev)
    a = replace(a, vals=randc((len(rt.uniq), a.rows.numel())))
    x = randc((KB, len(rt.src), h))
    seg = LaneSegments(tuple(int(v) for v in rt.slot_ptr))
    return {f"KB row panels {op} 4D n_end={N_END_4D}, {KB} k x {len(rt.src)} lanes":
            _per_launch_us(torch, lambda adj=adj: block_diag_cmm(a, x, seg, adjoint=adj))
            for op, adj in (("D^H", True), ("D", False))}


def lattice_sweep(torch, dev):
    """chip_smoke.py phase 9 (a): the 32 x 32 'ba' lattice at n_end=19,
    complex64, solver="auto" (the lattice route), with uscat(0)."""
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from chip_smoke import N_END_3D, N_SIDE_3D, square_lattice

    c = create_from_branching_types("ba")
    f = dict(dtype=torch.float32, device=dev)
    centers = torch.as_tensor(square_lattice(N_SIDE_3D, 3), **f)
    k = torch.tensor(1.0, **f)
    uin, _ = plane_wave(k=k, direction=torch.tensor([1.0, 0.0, 0.0], **f))

    def sweep():
        calc = biem(c, centers=centers, radii=torch.ones(len(centers), **f), k=k,
                    n_end=N_END_3D, uin=uin, stable=True)
        calc.uscat(torch.zeros(3, 1, **f))

    return sweep, [1.0]


def lattice_times(torch, dev):
    """Device us per launch of KG at phase 9 (b)'s n_end=32 table and of the
    lattice matvec's FFTs and per-frequency product, complex64."""
    from biem_helmholtz_sphere_tpu_torch.biem._lattice import _half_offsets, lattice_routing
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops.graf import graf_fold
    from biem_helmholtz_sphere_tpu_torch.special import spherical_h_scaled
    from biem_helmholtz_sphere_tpu_torch.translation._ops import _a_node_m
    from chip_smoke import GATES_2D, N_END_3D, N_SIDE_2D, N_SIDE_3D, square_lattice

    n_end = GATES_2D[-1]
    h = 2 * n_end - 1
    _, _, t = _half_offsets(lattice_routing(square_lattice(N_SIDE_2D, 2)), 2)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    r, theta = torch.linalg.vector_norm(t, dim=1), torch.atan2(t[:, 1], t[:, 0])[None]
    hm, he = spherical_h_scaled(2, h, r[None])
    m = torch.as_tensor(_a_node_m(create_from_branching_types("a"), n_end), device=dev)
    e = -20.0 * torch.rand(1, h, device=dev)
    out = {f"KG fold, {len(t)} offsets x {h} x {h}":
           _per_launch_us(torch, lambda: graf_fold(hm, theta, m, m, he, e, e))}
    for label, n_side, hh in ((f"(a) 3D n_end={N_END_3D}", N_SIDE_3D, N_END_3D ** 2),
                              (f"(b) 2D n_end={n_end}", N_SIDE_2D, h)):
        f2 = 4 * n_side * n_side
        z = torch.zeros((1, 2 * n_side, 2 * n_side, hh), dtype=torch.complex64, device=dev)
        khat = torch.zeros((f2, hh, hh), dtype=torch.complex64, device=dev)
        zc = z.reshape(f2, hh, 1)
        out[f"fftn {label}"] = _all_device_us(torch, lambda: torch.fft.fftn(z, dim=(1, 2)), 20)
        out[f"per-frequency product {label}"] = _all_device_us(
            torch, lambda: torch.matmul(khat, zc), 20)
        out[f"ifftn {label}"] = _all_device_us(torch, lambda: torch.fft.ifftn(z, dim=(1, 2)), 20)
        del z, khat, zc
    return out


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import bench_sweep

    if not torch.cuda.is_available():
        print("torch_profile_sweep: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda", 0)
    if "--host-only" in sys.argv[1:]:
        print(f"card: {card}")
        _print_host_times(torch, dev)
        return 0
    four = "--4d" in sys.argv[1:]
    lattice = "--lattice" in sys.argv[1:]
    if four:
        sweep, ks = four_d_sweep(torch, dev)
    elif lattice:
        sweep, ks = lattice_sweep(torch, dev)
    else:
        _, sweep, ks = bench_sweep(torch, dev)

    sweep()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n_kernels = busy_us(prof)
    print(f"card: {card}")
    print(f"profiled sweep of {len(ks)} k: wall {wall:.6f} s, device busy "
          f"{busy * 1e-6:.6f} s over {n_kernels} device events, idle share "
          f"{1.0 - busy * 1e-6 / wall:.4f}")
    rows = [(e.key, _device_time(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    print("device time by name (ms total, count, us per call):")
    for key, t_us, n in rows[:25]:
        print(f"  {t_us * 1e-3:10.4f} ms  {n:6d}  {t_us / max(n, 1):9.2f} us  {key[:90]}")
    print("the port's own kernels (csrc/), by their CUDA names among the device events:")
    port = sorted(_port_kernel_rows(prof).items(), key=lambda r: -r[1][0])
    if not port:
        raise RuntimeError("no device event of the sweep names a kernel of csrc/")
    for key, (t_us, n) in port:
        print(f"  {t_us * 1e-3:10.4f} ms  {n:6d}  {t_us / max(n, 1):9.2f} us  {key[:90]}")
    if four or lattice:
        print("each alone, device us per launch (complex64):")
        times = four_d_kb_times(torch, dev) if four else lattice_times(torch, dev)
        for label, us in times.items():
            print(f"  {us:9.2f} us  {label}")
        return 0
    print("each alone, device us per launch (bench widths, complex64):")
    for label, us in (kernel_device_times(torch, dev) | plain_stage_device_times(torch, dev)
                      ).items():
        print(f"  {us:9.2f} us  {label}")
    _print_host_times(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
