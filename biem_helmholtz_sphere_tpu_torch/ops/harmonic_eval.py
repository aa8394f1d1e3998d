r"""KE: the general field evaluation (the near field of `harmonic_sum`).

    u[p, k(, b)] = sum_b sum_h w[k, b, h] rad_{n_h}(k |x_p - c_b|) Y_h(x_p - c_b)

for every tree but the 3D "ba" one (KA's), with rad_n = h_n clamped as
`special/_family.py::_h_clamped` (an underflowed density never meets an
overflowed h: 0 * inf = NaN).  On CUDA tensors `harmonic_eval` launches
`csrc/harmonic_eval.cu`, which walks the child states of the tree's
program in KE's order (`ops/harmonic_program.py::ke_walk_numpy`, each
one step at one node from the last, the nodes' factors carried in
registers): per (point, k, ball) and child state the root's degree
recurrence with the density and the radial factor folded in, times the
subtree's factors; nothing of size [P, B, H] reaches device memory.
The radial factor comes, in d = 3, from the upward h chain in the kernel
(`csrc/hankel.cuh`, KA's), else from a K5 launch in its h-only mode
(`special/_family.py::spherical_h_scaled`, every d, the cylinder seeds of
even d in float64), point chunk by point chunk within _H_BYTES, its clamp
applied in the kernel.  The many-point mode keeps the density and each
thread's radial tables in shared memory at any n_end (`_many_point_layout`:
the density in windows when that leaves an SM more warps, the radial
tables in a device scratch at n_end in the hundreds) and slices the balls
over the card's waves (`_ball_slices`).  On CPU
tensors it runs `_harmonic_eval_plain`, the
JAX package's general evaluation (biem_helmholtz_sphere_tpu/biem/
_eval.py:146-148) in plain torch: the harmonics at x - c_b, their product
with the radial factor and the density, summed over the harmonics.

The far field does not come here: it is the harmonics at x and one
`torch.matmul` with the density (biem/_eval.py::harmonic_sum), a library
product that the JAX package also computes outside any kernel.
"""

import ctypes
from functools import lru_cache

import torch

from ..coords import from_cartesian
from ..harmonics._eval import harmonics
from ..harmonics._index import basis
from ..special._family import _clamp_limit, _h_clamped, _rescale_for, spherical_h_scaled
from . import kernels
from .harmonic_program import harmonic_program, ke_runs, program_numpy

# bytes of the [K, P_chunk, B, H] complex temporaries of one chunk of the
# plain version (its harmonics, the radial factor, their product)
_EVAL_BYTES = 1 << 30
# bytes of one chunk's K5 output [K, P_chunk, B, n_end] (mantissa and
# exponent) on the kernel's path
_H_BYTES = 1 << 28
# few-point mode: CTAs a launch aims at (4 per SM of a 132-SM H100); fewer
# points x k split the balls over the grid
_FILL_CTAS = 4 * 132
_FEW_WARPS = 8  # harmonic_eval.cu kFewWarps
# the many-point mode's shared memory: at most an H100's 227 KiB a CTA, of
# its SM's 228 KiB, 1 KiB of them reserved a CTA; the density's window where
# it is not whole
_SMEM = 227 * 1024
_SMEM_SM = 228 * 1024
_SMEM_CTA = 1024
_WINDOW = 2048
# the many-point mode's points a thread by real dtype (harmonic_eval.cu kPT:
# two in complex64, one in complex128, whose radial tables would leave an
# SM one warp a scheduler at two) and its threads a CTA (the most that fit,
# harmonic_eval.cu kMaxThreads at most)
_PT = {torch.float32: 2, torch.float64: 1}
_THREADS = (128, 64, 32)
# a work unit's (tile of points, slice of balls) fixed cost, in balls, when
# sizing the slices against the card's waves
_UNIT_COST = 0.05


def tree_radius(c, x):
    """|x| over the leading (cartesian) axis by the tree's hypot chain:
    bitwise `from_cartesian(c, x)["r"]`, without its angles."""

    def walk(node):
        if node.kind == "a":
            return torch.hypot(x[node.axes[0]], x[node.axes[1]])
        if node.kind in ("b", "bp"):
            return torch.hypot(walk(node.children[0]), x[node.axis])
        return torch.hypot(walk(node.children[0]), walk(node.children[1]))

    return walk(c.root)


def _harmonic_eval_plain(c, n_end, x, centers, k, w, per_ball):
    """The plain version: chunked over the points so that each chunk's
    [K, P_chunk, B, H] temporaries stay within _EVAL_BYTES (the chunking
    does not change the arithmetic)."""
    d, _, n_p = x.shape
    n_k, n_balls, h_num = w.shape
    n_idx = torch.as_tensor(basis(c, n_end).n_root, dtype=torch.long, device=w.device)
    per_point = 3 * n_k * n_balls * h_num * w.element_size()
    chunk = max(1, _EVAL_BYTES // per_point)
    outs = []
    for s in range(0, n_p, chunk):
        xs = x[..., s : s + chunk]
        rel = xs[..., None] - centers.permute(2, 0, 1)[:, :, None, :]  # [d, K, P, B]
        sph = from_cartesian(c, rel)
        rad = _h_clamped(d, n_end, k[:, None, None] * sph["r"]).index_select(-1, n_idx)
        u = (harmonics(c, sph, n_end) * (rad * w[:, None])).sum(-1)  # [K, P, B]
        outs.append(u.transpose(0, 1) if per_ball else u.sum(-1).transpose(0, 1))
    return torch.cat(outs, dim=0)


@lru_cache(maxsize=64)
def _many_point_layout(c, n_end, elt):
    """(wwin, glob, threads) of the many-point mode for complex elements of
    `elt` bytes: the density in shared memory whole (wwin = H) or in
    windows of wwin entries (each child state's entries whole), beside the
    radial tables of `threads` x pt points, as leaves an SM the most warps
    (the CTAs of _SMEM_SM that fit; ties: the whole density, then more
    threads); the radial tables in a device scratch (glob) where no such
    layout leaves 4 warps (n_end in the hundreds)."""
    t = program_numpy(c, n_end)
    h_num = t["h_num"]
    pt = _PT[torch.float32 if elt == 8 else torch.float64]
    wwin = min(h_num, max(_WINDOW, int(t["cs"][:, 1].max())))

    def smem(win, threads):  # harmonic_eval.cu many_smem
        return ((win + 1) // 2 * 2 + n_end * threads * pt) * elt

    fits = [((_SMEM_SM // (smem(win, threads) + _SMEM_CTA)) * threads // 32, win, threads)
            for win in {h_num, wwin} for threads in _THREADS if smem(win, threads) <= _SMEM]
    best = max(fits, default=(0,))
    if best[0] < 4:
        return wwin, True, _THREADS[0]
    return best[1], False, best[2]


@lru_cache(maxsize=256)
def _blocks_per_sm(shape, rad, threads, n_end, wwin, glob, dbl):
    """CTAs of the many-point instance an SM holds (the CUDA occupancy
    calculator, on the current card)."""
    blocks = ctypes.c_int(0)
    pt = _PT[torch.float64 if dbl else torch.float32]
    err = kernels.library().bhs_harmonic_eval_occupancy(
        shape, rad, threads, pt, n_end, wwin, int(glob), dbl, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"harmonic_eval: occupancy query failed (CUDA error {err}, "
                           f"{blocks.value} CTAs an SM)")
    return blocks.value


@lru_cache(maxsize=256)
def _ball_slices(n_units, n_b, slots):
    """Balls a slice for n_units (tile of points, k) pairs over n_b balls
    on `slots` resident CTAs: the slicing whose makespan, waves x (balls a
    slice + _UNIT_COST), is least (no wave left mostly empty)."""
    best = None
    for bpz in sorted({-(-n_b // s) for s in range(1, n_b + 1)}):
        waves = -(-n_units * -(-n_b // bpz) // slots)
        cost = waves * (bpz + _UNIT_COST)
        if best is None or cost < best[0]:
            best = (cost, bpz)
    return best[1]


@lru_cache(maxsize=32)
def _tables(c, n_end, dtype, device):
    """(program, the addresses of its tables as a launch takes them):
    the launch's arguments that depend on (tree, n_end, dtype, device)
    alone, cached with the program that holds their memory."""
    prog = harmonic_program(c, n_end, dtype, device)
    ptr = [t.data_ptr() for t in (prog.ke_perm, prog.nodes, prog.jobs, prog.fam, prog.coef,
                                  prog.famr, prog.walk, prog.wfam, prog.wroot, prog.wstep,
                                  prog.wjob)]
    return prog, (*ptr[:6], prog.n_nodes, prog.shape, *ptr[6:])


@lru_cache(maxsize=64)
def _runs_on(c, n_end, lanes, device):
    """(`ke_runs` of `lanes` few-point lanes on `device`, its address)."""
    runs = torch.as_tensor(ke_runs(c, n_end, lanes), device=device)
    return runs, runs.data_ptr()


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def harmonic_eval(c, n_end, x, centers, k, w, per_ball=False):
    """The near field sum_h w_h rad_{n_h} Y_h(x - c_b): complex [P, K], or
    [P, K, B] with per_ball.

    x: real [d, Kx, P] (Kx = 1 shares the points over the batch); centers:
    real [K, B, d] (a geometry shared by the batch may be a stride-0 view
    along K); k: real or complex [K]; w: complex [K, B, H].  CPU tensors
    run the plain version; CUDA tensors launch KE (or raise), one launch per
    chunk of points, each counted in `harmonic_eval.launches`: in its
    few-point mode when P K < `kernels.FEW_POINTS` (KA's threshold; also counted
    in `harmonic_eval.few_launches`), else its many-point mode.
    """
    d, n_kx, n_p = x.shape
    n_k, n_b, h_num = w.shape
    if (d != c.c_ndim or n_kx not in (1, n_k) or centers.shape != (n_k, n_b, d)
            or k.shape != (n_k,)):
        raise ValueError(
            f"harmonic_eval: x {tuple(x.shape)}, centers {tuple(centers.shape)}, "
            f"k {tuple(k.shape)}, w {tuple(w.shape)} do not match")
    if x.device.type == "cpu":
        return _harmonic_eval_plain(c, n_end, x, centers, k, w, per_ball)
    if x.device.type != "cuda":
        raise RuntimeError(f"harmonic_eval: unsupported device {x.device}")
    rdt = x.dtype
    cdt = {torch.float32: torch.complex64, torch.float64: torch.complex128}.get(rdt)
    if cdt is None or w.dtype != cdt or centers.dtype != rdt or k.dtype not in (rdt, cdt):
        raise TypeError(f"harmonic_eval: dtypes x {rdt}, centers {centers.dtype}, "
                        f"k {k.dtype}, w {w.dtype}")
    prog, tables = _tables(c, n_end, rdt, x.device)
    if prog.h_num != h_num:
        raise ValueError(f"harmonic_eval: {h_num} harmonics, n_end={n_end} has {prog.h_num}")
    w = w.contiguous()  # read in KE's order through ke_perm by the kernel
    if centers.stride()[1:] != (d, 1):  # each k's [B, d] contiguous; any k stride
        centers = centers.contiguous()
    out = torch.empty((n_p, n_k, n_b) if per_ball else (n_p, n_k), dtype=cdt, device=x.device)
    few = n_p * n_k < kernels.FEW_POINTS
    dbl = int(rdt == torch.float64)
    pt = _PT[rdt]
    wwin, glob, threads = _many_point_layout(c, n_end, w.element_size())
    # d = 3: the h chain in the kernel (hankel.cuh), on a real or complex k r;
    # else K5's h-only table, point chunk by point chunk
    rad = (2 if k.is_complex() else 1) if d == 3 else 0
    k = k.contiguous()
    per_point = n_k * n_b * n_end * (w.element_size() + x.element_size())
    chunk = max(1, _H_BYTES // per_point if not rad or glob else n_p)
    if not few:
        slots = _blocks_per_sm(prog.shape, rad, threads, n_end, wwin, glob, dbl) * _sm_count(
            x.device)
    for s in range(0, n_p, chunk):
        xs = x[..., s : s + chunk]
        n_pc = xs.shape[-1]
        hm = he = xs  # not read by the chain
        if not rad:
            rel = xs[..., None] - centers.permute(2, 0, 1)[:, :, None, :]  # [d, K, Pc, B]
            hm, he = spherical_h_scaled(d, n_end, k[:, None, None] * tree_radius(c, rel))
        # slices of the balls over the grid: few-point mode, when the points
        # alone give too few CTAs (warps per ball as the slice leaves room);
        # many-point mode, sized to the card's waves; each slice writes its
        # sum (or its balls' fields), summed below
        wpb, runs = 1, 0  # (runs: not read in the many-point mode)
        if few:
            bpz = -(-n_b // min(n_b, -(-_FILL_CTAS // (n_pc * n_k))))
            while wpb < _FEW_WARPS and _FEW_WARPS // (2 * wpb) >= bpz:
                wpb *= 2
            runs = _runs_on(c, n_end, 32 * wpb, x.device)[1]
        else:
            bpz = _ball_slices(-(-n_pc // (threads * pt)) * n_k, n_b, slots)
        n_slices = -(-n_b // bpz)
        dst = out[s : s + chunk]
        if n_slices > 1 and not per_ball:
            dst = torch.empty((n_pc, n_k, n_slices), dtype=cdt, device=x.device)
        sx = xs.stride()
        # the radial tables' scratch: n_end x pt per thread of the grid
        hs = (torch.empty(n_end * pt * threads * -(-n_pc // (threads * pt)) * n_k * n_slices,
                          dtype=cdt, device=x.device) if glob and not few else None)
        kernels.launch(
            "bhs_harmonic_eval", xs, sx[0], sx[1], sx[2], n_kx, centers, centers.stride(0), rad,
            hm, he, k, _rescale_for(rdt), w, *tables, runs, dst, n_pc, n_k, n_b, n_end, h_num,
            prog.n_cs, d, prog.root_step,
            int(per_ball), int(few), bpz, _clamp_limit(rdt), wwin, threads, pt, wpb, hs, dbl)
        if n_slices > 1 and not per_ball:
            torch.sum(dst, -1, out=out[s : s + chunk])
        harmonic_eval.launches += 1
        harmonic_eval.few_launches += int(few)
    return out


harmonic_eval.launches = 0
harmonic_eval.few_launches = 0  # of them, launches in the few-point mode
