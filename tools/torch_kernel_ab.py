"""A/B device times of KB, KA, K5, KC, K2, KS, KF, KE, K3 and KU source variants on one card.

    python tools/torch_kernel_ab.py [-k SUBSTRING] DIR [DIR ...]

Run from the repository root on a machine with a CUDA card and nvcc (no
JAX needed).  Each DIR holds a full copy of
biem_helmholtz_sphere_tpu_torch/csrc/ with the variant's edits, and may
hold a file `py_params` of Python assignments applied to
ops/block_diag.py and translation/_rotation.py (e.g. `_LANE_TILE = 4` when
a variant changes KB's register tile, `_K3_LINES = {False: 210, True: 96}`
when it changes K3's ring) and ops/harmonic_eval.py (`_PT = {torch.float32: 4,
torch.float64: 1}` when it takes KE to four points a thread in complex64).  `biem_helmholtz_sphere_tpu_torch/csrc` itself is a valid
DIR.  For each variant the script builds the kernel library from DIR,
checks every case against its plain version (relative error printed),
then times each case in turns (v1 .. vn, vn .. v1, three times; the
card's name and power limit first, `tools/ab_common.py`) and
prints the median, fastest and slowest device microseconds per launch of
each case and variant, in complex64 and complex128: the device time of
the port's kernels per launch (torch.profiler), or, for KS, one call
between CUDA events after a warm-up call (torch.profiler lost the device
events of some of its seconds-long launches on the H100: whole turns read
0).  Cases, at the bench widths (16 spheres on the 4x4 lattice, n_end =
32, 4 k): KB's three products on the compacted lanes, KA at 131,072
points x 1 k and at 1 point x 4 k, K5's three launch shapes of a k-block
(scaled and unscaled at 4 k x 16 radii x 32 orders, h only at 4 k x 9
distances x 63 bands; compared on the values mant exp(e)), the KC gather
and K2 for a k-block (4 k x 9 radii); and KS (its KF and KS launches) at
chip_smoke.py phase 10 (a)'s shapes: 'caa' at n_end = 14 (H = 1,015,
Q = 43,740 nodes), 4 k x 40 offsets of the hypercube {-2, 2}^4,
complex64 in fold mode and complex128 unscaled; KF (`band_f`) alone there
("KF": the first group of offsets, 53 in complex64, 26 in complex128, at
27 bands; "KF wide": 8 offsets at 33 bands; `-k KF` builds only KF and
K5, and prints whether each variant's F equals the first variant's bit
for bit: give the parent's csrc/ first to compare against it); KE (`harmonic_eval`) at
phase 7 (c)'s shapes ('bpa' at the bench, 131,072 points x 1 k) and
phase 8 (a)'s ("KE 4d": 'bba' on the hypercube at n_end = 20, 16,384
points; `-k KE` builds only KE and K5 for them) and K3
(`rotation_blocks`, its harmonics pass and its product, slab by slab) at
phase 8 (a)'s ('bba' on the hypercube at n_end = 20, its 64 slot
directions), phase 4's ("K3 bench": the 36 slots at n_end = 32) and phase
9 (a)'s ("K3 lattice": the 32 x 32 lattice's 1,984 half-table directions
at n_end = 19), all timed as KS is; KU (`coax_u`, the coax band tables:
"KU bench" at 'ba' n_end = 32, "KU 64" at 'ba' n_end = 64, "KU 4d" at
phase 8 (a)'s 'bba' n_end = 20, tables in the complex dtype's real type;
`-k KU` builds only KU).  A variant of another interface (K3's
parent commit) is timed by that commit's own copy of this script, run
from its unpacked tree in the same call (or by tools/torch_k3_ab.py).
With -k, only the cases whose name contains SUBSTRING run (`-k KS`, `-k
KE`, `-k K3` build those cases' inputs alone).
"""

import functools
import os
import statistics
import sys
from dataclasses import replace
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def cases(torch, dev, cdt):
    import numpy as np

    from biem_helmholtz_sphere_tpu_torch.biem._core import _pair_routing
    from biem_helmholtz_sphere_tpu_torch.biem._eval_fused import (
        _fused_ba_eval_plain, fused_ba_eval, regroup)
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics import basis
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
        LaneSegments, _block_diag_cmm_plain, block_diag_cmm, pack, unpack)
    from biem_helmholtz_sphere_tpu_torch.ops.lane_route import (
        _lane_gather_plain, lane_gather, make_route)
    from biem_helmholtz_sphere_tpu_torch.special._family import (
        _H_ONLY, _SCALED, _UNSCALED, _spherical_h_scaled_plain, _spherical_jh_all_plain,
        _spherical_jh_scaled_plain, spherical_jh)
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import (
        _child_state_blocks, _coax_fold_packed_plain, coax_fold)
    from chip_smoke import EVAL_POINTS, KB, N_END, coax_args, lattice_centers

    c = create_from_branching_types("ba")
    h = N_END * N_END
    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
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
    dd, xd = unpack(d_bd), unpack(x_bd)
    cen = torch.as_tensor(centers_np, dtype=rdt, device=dev)
    ell = torch.as_tensor(basis(c, N_END).n_root, device=dev)
    w1 = regroup(c, N_END, randc((1, len(centers_np), h)) * torch.exp(-ell.to(rdt)))
    w4 = regroup(c, N_END, randc((KB, len(centers_np), h)) * torch.exp(-ell.to(rdt)))
    pts = torch.as_tensor(rng.normal(size=(3, 1, EVAL_POINTS)) * 20.0, dtype=rdt, device=dev)
    zero = torch.zeros((3, 1, 1), dtype=rdt, device=dev)
    k1 = torch.full((1,), 8.0, dtype=rdt, device=dev)
    k4 = torch.linspace(7.0, 7.06, KB, dtype=rdt, device=dev)
    outside = (torch.linalg.vector_norm(pts[:, 0, :, None] - cen.T[:, None, :], dim=0)
               > 1.0).all(-1)
    nb = len(centers_np)
    z_rows = (k4[:, None] * torch.ones(nb, dtype=rdt, device=dev)).to(cdt)
    z_coax = (k4[:, None] * torch.as_tensor(rt.uniq_r, dtype=rdt, device=dev)).to(cdt)

    def values(out):
        """K5's outputs as one tensor of values (mant exp(e) where scaled)."""
        if isinstance(out[0], tuple):
            return torch.stack([m * torch.exp(e) for m, e in out])
        if out[1].is_complex():
            return torch.stack(out)
        return out[0] * torch.exp(out[1])

    route = make_route(rt.src, rt.dst, rt.dn, nb, dev)
    pm = ((-1.0) ** (ell % 2)).to(rdt)
    xv, blc = randc((KB, nb, h)), randc((KB, nb, h))
    k2 = coax_args(torch, dev, rdt)
    return {  # name: (kernel call, plain call, mask of compared entries, reps)
        "KB D^H": (lambda: block_diag_cmm(d_bd, lanes, d_seg, adjoint=True),
                   lambda: _block_diag_cmm_plain(dd, lanes, d_seg, True), None, 50),
        "KB X": (lambda: block_diag_cmm(x_bd, lanes, x_seg),
                 lambda: _block_diag_cmm_plain(xd, lanes, x_seg, False), None, 50),
        "KB D": (lambda: block_diag_cmm(d_bd, lanes, d_seg),
                 lambda: _block_diag_cmm_plain(dd, lanes, d_seg, False), None, 50),
        f"KA {EVAL_POINTS} pts": (lambda: fused_ba_eval(pts, cen, k1, w1),
                                  lambda: _fused_ba_eval_plain(pts, cen, k1, w1, False, False),
                                  outside, 5),
        f"KA 1 pt x {KB} k": (lambda: fused_ba_eval(zero, cen, k4, w4),
                              lambda: _fused_ba_eval_plain(zero, cen, k4, w4, False, False),
                              None, 50),
        "K5 scaled": (lambda: values(spherical_jh(_SCALED, 3, N_END, z_rows)),
                      lambda: values(_spherical_jh_scaled_plain(3, N_END, z_rows)), None, 50),
        "K5 unscaled": (lambda: values(spherical_jh(_UNSCALED, 3, N_END, z_rows)),
                        lambda: values(_spherical_jh_all_plain(3, N_END, z_rows)), None, 50),
        "K5 h only": (lambda: values(spherical_jh(_H_ONLY, 3, 2 * N_END - 1, z_coax)),
                      lambda: values(_spherical_h_scaled_plain(3, 2 * N_END - 1, z_coax)),
                      None, 50),
        "KC gather": (lambda: lane_gather(xv, blc, pm, route),
                      lambda: _lane_gather_plain(xv, blc, pm, route), None, 50),
        "K2": (lambda: coax_fold(*k2), lambda: _coax_fold_packed_plain(*k2), None, 50),
    }


@functools.cache
def _ks_args(torch, dev, cdt):
    """KS's arguments at chip_smoke.py phase 10 (a)'s shapes: complex64 in
    fold mode, complex128 unscaled."""
    import numpy as np

    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import band_coefs
    from biem_helmholtz_sphere_tpu_torch.special._family import spherical_h_scaled
    from biem_helmholtz_sphere_tpu_torch.translation._ops import _band_consts, _quad_tables
    from chip_smoke import KB, N_END_C, hypercube_centers, sweep_ks_4d

    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
    f = dict(dtype=rdt, device=dev)
    tab = _quad_tables(create_from_branching_types("caa"), N_END_C, N_END_C, rdt, dev)
    cube = hypercube_centers()
    t = np.unique(np.round((cube[:, None] - cube[None]).reshape(-1, 4), 9), axis=0)
    t = t[np.linalg.norm(t, axis=1) > 0][:40]
    r = np.linalg.norm(t, axis=1)
    t_hat = torch.as_tensor((t / r[:, None])[None], **f)
    k = torch.as_tensor(sweep_ks_4d()[:KB], **f)
    hm, he = spherical_h_scaled(4, tab.n_bands, k[:, None] * torch.as_tensor(r, **f))
    if cdt == torch.complex128:
        return (band_coefs(hm * torch.exp(he), 4, *_band_consts(4)), t_hat, tab), {}
    rng = np.random.default_rng(3)
    h = tab.yo.shape[1]
    kw = dict(he=he, e_r=-torch.as_tensor(rng.random((KB, h)) * 5, **f),
              e_b=-torch.as_tensor(rng.random((KB, h)) * 5, **f))
    return (band_coefs(hm, 4, *_band_consts(4), he=he), t_hat, tab), kw


def ks_case(torch, dev, cdt):
    """KS's case: (kernel call, plain call, None, None: timed between CUDA
    events), its arguments built at first use."""
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import _band_sr_plain, band_sr

    def args():
        return _ks_args(torch, dev, cdt)

    return (lambda: band_sr(*args()[0], **args()[1]),
            lambda: _band_sr_plain(*args()[0], **args()[1]), None, None)


def kf_cases(torch, dev, cdt):
    """KF's cases (device us a launch over 20 launches): "KF", the first
    group of offsets of KS's case (53 in complex64, 26 in complex128), and
    "KF wide", chip_smoke.py's KF_WIDE_OFFSETS offsets at KF_WIDE_BANDS
    bands on the same nodes, coefficients from h's mantissas and
    exponents."""
    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import (
        _band_f_plain, band_coefs, band_f, offset_groups)
    from biem_helmholtz_sphere_tpu_torch.special._family import spherical_h_scaled
    from biem_helmholtz_sphere_tpu_torch.translation._ops import _band_consts
    from chip_smoke import KF_WIDE_BANDS, KF_WIDE_OFFSETS

    @functools.cache
    def args(wide):
        (coef, t_hat, tab), _ = _ks_args(torch, dev, cdt)
        n_k, n_off, n_b = coef.shape[:3]
        if not wide:
            return coef, t_hat, tab, *offset_groups(n_k * n_off, tab.q_pad, n_b,
                                                   coef.element_size())[0]
        kr = torch.linspace(3.0, 12.0, n_k * n_off, dtype=t_hat.dtype, device=dev)
        hm, he = spherical_h_scaled(4, KF_WIDE_BANDS, kr.reshape(n_k, n_off))
        return (band_coefs(hm, 4, *_band_consts(4), he=he).contiguous(), t_hat, tab, 0,
                KF_WIDE_OFFSETS)

    return {name: (lambda w=wide: band_f(*args(w)), lambda w=wide: _band_f_plain(*args(w)),
                   None, 20) for name, wide in (("KF", False), ("KF wide", True))}


def ke_k3_cases(torch, dev, cdt):
    """KE's and K3's cases: (kernel call, plain call, None, None: timed
    between CUDA events), their arguments built at first use."""
    import numpy as np

    from biem_helmholtz_sphere_tpu_torch.biem._core import _offsets, _pair_routing
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics import basis
    from biem_helmholtz_sphere_tpu_torch.ops.harmonic_eval import (
        _harmonic_eval_plain, harmonic_eval)
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import (
        _rotation_blocks_plain, rotation_blocks)
    from chip_smoke import (EVAL_POINTS, EVAL_POINTS_4D, N_END, N_END_3D, N_END_4D, N_SIDE_3D,
                            hypercube_centers, lattice_centers, square_lattice)

    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
    f = dict(dtype=rdt, device=dev)

    @functools.cache
    def ke_args():
        c = create_from_branching_types("bpa")
        rng = np.random.default_rng(77)
        ell = basis(c, N_END).n_root
        x = torch.as_tensor(rng.normal(size=(3, 1, EVAL_POINTS)) * 20.0, **f)
        w = torch.as_tensor((rng.normal(size=(1, 16, len(ell))) + 1j) * np.exp(-ell),
                            dtype=cdt, device=dev)
        cen = torch.as_tensor(lattice_centers(), **f)[None]
        return c, N_END, x, cen, torch.tensor([7.0], **f), w

    @functools.cache
    def k3_args(shape):
        tree, n_end, dirs = {
            "4d": ("bba", N_END_4D, lambda: _pair_routing(hypercube_centers()).uniq),
            "bench": ("ba", N_END, lambda: _pair_routing(lattice_centers()).uniq),
            "lattice": ("ba", N_END_3D, lambda: _offsets(square_lattice(N_SIDE_3D, 3))[0]),
        }[shape]
        t = torch.as_tensor(dirs(), **f)
        return create_from_branching_types(tree), t / t.norm(dim=-1, keepdim=True), n_end

    def flat(blocks):
        return torch.cat([b.flatten(1) for b in blocks], dim=-1)

    def k3(shape):
        return (lambda: flat(rotation_blocks(*k3_args(shape))[1]),
                lambda: flat(_rotation_blocks_plain(*k3_args(shape))[1]), None, None)

    @functools.cache
    def ke4_args():
        c = create_from_branching_types("bba")
        rng = np.random.default_rng(77)
        ell = basis(c, N_END_4D).n_root
        x = torch.as_tensor(rng.normal(size=(4, 1, EVAL_POINTS_4D)) * 20.0, **f)
        w = torch.as_tensor((rng.normal(size=(1, 16, len(ell))) + 1j) * np.exp(-ell),
                            dtype=cdt, device=dev)
        cen = torch.as_tensor(hypercube_centers(), **f)[None]
        return c, N_END_4D, x, cen, torch.tensor([7.0], **f), w

    return {"KE": (lambda: harmonic_eval(*ke_args()),
                   lambda: _harmonic_eval_plain(*ke_args(), False), None, None),
            "KE 4d": (lambda: harmonic_eval(*ke4_args()),
                      lambda: _harmonic_eval_plain(*ke4_args(), False), None, None),
            "K3": k3("4d"), "K3 bench": k3("bench"), "K3 lattice": k3("lattice")}


def ku_cases(torch, dev, cdt):
    """KU's cases: (kernel call, plain call, None, 20 launches timed) at
    chip_smoke.py phase 2's (ii), (iii) and (i)."""
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops.coax_u import _coax_u_plain, coax_u
    from biem_helmholtz_sphere_tpu_torch.translation._rotation import _coax_tables_on
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import _coax_plan_on

    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
    out = {}
    for name, tree, n_end in (("KU bench", "ba", 32), ("KU 64", "ba", 64), ("KU 4d", "bba", 20)):
        c = create_from_branching_types(tree)
        layout, plan = _coax_plan_on(c, n_end, dev)[:2]
        tables = _coax_tables_on(c, n_end, dev)

        def run(fn, tables=tables, layout=layout, plan=plan):
            return torch.cat([x.reshape(-1) for x in fn(tables, layout, plan, rdt)])

        out[name] = (functools.partial(run, coax_u), functools.partial(run, _coax_u_plain),
                     None, 20)
    return out


def _event_us(torch, fn):
    """Microseconds of one call of fn() between CUDA events, after a
    warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3


def main():
    import torch

    from biem_helmholtz_sphere_tpu_torch.ops import block_diag, kernels
    from biem_helmholtz_sphere_tpu_torch.ops import harmonic_eval as ke_mod
    from biem_helmholtz_sphere_tpu_torch.translation import _rotation
    from tools.torch_profile_sweep import _per_launch_us

    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    variants = sys.argv[1:]
    only = ""
    if variants[:1] == ["-k"]:
        only, variants = variants[1], variants[2:]
    if not variants:
        print(__doc__, file=sys.stderr)
        return 2
    defaults = [(mod, k, getattr(mod, k)) for mod, names in (
        (block_diag, ("_BUF_BYTES", "_ITEMS_PER_LAUNCH", "_ROW_TILE", "_LANE_TILE")),
        (_rotation, ("_K3_LINES", "_K3_SCRATCH")),
        (ke_mod, ("_PT", "_THREADS", "_UNIT_COST"))) for k in names]
    if only == "KE":  # KE's cases launch KE and K5 alone: build and bind those two
        kernels.SOURCES = ("harmonic_eval.cu", "spherical_jh.cu")
        kernels._SIGNATURES = {n: a for n, a in kernels._SIGNATURES.items()
                               if n.startswith(("bhs_harmonic_eval", "bhs_spherical_jh"))}
    if only == "KU":  # KU's cases launch KU alone
        kernels.SOURCES = ("coax_u.cu",)
        kernels._SIGNATURES = {n: a for n, a in kernels._SIGNATURES.items() if n == "bhs_coax_u"}
    if only == "KF":  # KF's cases launch KF and K5 (the wide case's coefficients)
        kernels.SOURCES = ("band_sr.cu", "spherical_jh.cu")
        kernels._SIGNATURES = {n: a for n, a in kernels._SIGNATURES.items()
                               if n.startswith(("bhs_band_", "bhs_spherical_jh"))}

    def use(vdir):
        kernels.CSRC = Path(vdir).resolve()
        kernels.BUILD_DIR = Path(vdir).resolve() / "out"
        kernels._lib = None
        for mod, name, val in defaults:
            setattr(mod, name, val)
        params = Path(vdir) / "py_params"
        if params.exists():  # the same assignments in every module
            for mod in (block_diag, _rotation, ke_mod):
                exec(params.read_text(), vars(mod))
        for fn in (block_diag._plan, _rotation._k3_plan, _rotation._k3_jobs,
                   _rotation._k3_tables, ke_mod._many_point_layout, ke_mod._blocks_per_sm,
                   ke_mod._ball_slices):
            fn.cache_clear()
        kernels.library()

    from tools.ab_common import card_line

    print(f"card: {card_line()}")
    dev = torch.device("cuda", 0)
    for cdt in (torch.complex64, torch.complex128):
        cs = {} if only in ("KS", "KF", "KE", "K3", "KU") else cases(torch, dev, cdt)
        if only == "KU":
            cs = ku_cases(torch, dev, cdt)
        elif only == "KF":
            cs = kf_cases(torch, dev, cdt)
        else:
            cs = {name: case for name, case in
                  {**cs, "KS": ks_case(torch, dev, cdt), **kf_cases(torch, dev, cdt),
                   **ke_k3_cases(torch, dev, cdt)}.items()
                  if only in name}
        times = {v: {name: [] for name in cs} for v in variants}
        first = {}  # KF's output of the first variant, for its bits
        for v in variants:
            use(v)
            for name, (kfn, pfn, mask, _) in cs.items():
                got, ref = kfn(), pfn()
                if mask is not None:
                    got, ref = got[mask], ref[mask]
                err = float((got - ref).abs().max() / ref.abs().max())
                bits = ""
                if name.startswith("KF"):
                    if name in first:
                        bits = (f"; bits equal to {variants[0]}'s: "
                                f"{torch.equal(torch.view_as_real(got).view(torch.uint8), first[name])}")
                    else:
                        first[name] = torch.view_as_real(got).view(torch.uint8).clone()
                del got, ref
                print(f"{v} {cdt} {name}: max rel err {err:.3e}{bits}")
        first.clear()
        for _ in range(3):
            for v in variants + variants[::-1]:
                use(v)
                for name, (kfn, _, _, reps) in cs.items():
                    times[v][name].append(_event_us(torch, kfn) if reps is None
                                          else _per_launch_us(torch, kfn, reps))
        for v in variants:
            med = {name: (round(statistics.median(t), 2), round(min(t), 2), round(max(t), 2))
                   for name, t in times[v].items()}
            print(f"{v} {cdt} device us per launch (median, fastest, slowest): {med}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
