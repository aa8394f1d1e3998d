r"""KE: the general field evaluation (the near field of `harmonic_sum`).

    u[p, k(, b)] = sum_b sum_h w[k, b, h] rad_{n_h}(k |x_p - c_b|) Y_h(x_p - c_b)

for every tree but the 3D "ba" one (KA's), with rad_n = h_n clamped as
`special/_family.py::_h_clamped` (an underflowed density never meets an
overflowed h: 0 * inf = NaN).  On CUDA tensors `harmonic_eval` launches
`csrc/harmonic_eval.cu`, which walks the tree's program
(`ops/harmonic_program.py`): per (point, k, ball) and child state the
root's degree recurrence in registers with the density and the radial
factor folded in, then the subtree's factors from the device evaluator
(`csrc/harmonics.cuh`); nothing of size [P, B, H] reaches device memory.
The radial factor comes, in d = 3, from the upward h chain in the kernel
(`csrc/hankel.cuh`, KA's), else from a K5 launch in its h-only mode
(`special/_family.py::spherical_h_scaled`, every d, the cylinder seeds of
even d in float64), point chunk by point chunk within _H_BYTES, its clamp
applied in the kernel.  The many-point mode keeps the density and each
thread's radial table in shared memory at any n_end: the density in
windows when it does not fit whole, the radial tables in a device scratch
when even a window leaves them no room (n_end in the hundreds).  On CPU
tensors it runs `_harmonic_eval_plain`, the
JAX package's general evaluation (biem_helmholtz_sphere_tpu/biem/
_eval.py:146-148) in plain torch: the harmonics at x - c_b, their product
with the radial factor and the density, summed over the harmonics.

The far field does not come here: it is the harmonics at x and one
`torch.matmul` with the density (biem/_eval.py::harmonic_sum), a library
product that the JAX package also computes outside any kernel.
"""

import torch

from ..coords import from_cartesian
from ..harmonics._eval import harmonics
from ..harmonics._index import basis
from ..special._family import _clamp_limit, _h_clamped, _rescale_for, spherical_h_scaled
from . import kernels
from .harmonic_program import harmonic_program, program_numpy

# bytes of the [K, P_chunk, B, H] complex temporaries of one chunk of the
# plain version (its harmonics, the radial factor, their product)
_EVAL_BYTES = 1 << 30
# bytes of one chunk's K5 output [K, P_chunk, B, n_end] (mantissa and
# exponent) on the kernel's path
_H_BYTES = 1 << 28
# CTAs a launch aims at (4 per SM of a 132-SM H100): fewer points x k split
# the balls over the grid
_FILL_CTAS = 4 * 132
# the many-point mode's shared memory: at most an H100's 227 KiB a CTA; the
# density's window when all of it does not fit beside the radial tables
_SMEM = 227 * 1024
_WINDOW = 2048
_THREADS = 128  # the many-point mode's threads a CTA (harmonic_eval.cu kThreads)


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


def _many_point_layout(c, n_end, elt):
    """(wwin, glob) of the many-point mode for complex elements of `elt`
    bytes: the density whole in shared memory (wwin = H) if it fits beside
    the radial tables, else in windows of wwin entries (each child state's
    entries whole); the radial tables in a device scratch (glob) if even a
    window leaves them no room."""
    t = program_numpy(c, n_end)
    h_num = t["h_num"]
    if (h_num + n_end * _THREADS) * elt <= _SMEM:
        return h_num, False
    wwin = min(h_num, max(_WINDOW, int(t["cs"][:, 1].max())))
    return wwin, (wwin + n_end * _THREADS) * elt > _SMEM


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
    prog = harmonic_program(c, n_end, rdt, x.device)
    if prog.h_num != h_num:
        raise ValueError(f"harmonic_eval: {h_num} harmonics, n_end={n_end} has {prog.h_num}")
    wp = w.index_select(-1, prog.perm).contiguous()
    if centers.stride()[1:] != (d, 1):  # each k's [B, d] contiguous; any k stride
        centers = centers.contiguous()
    out = torch.empty((n_p, n_k, n_b) if per_ball else (n_p, n_k), dtype=cdt, device=x.device)
    few = n_p * n_k < kernels.FEW_POINTS
    wwin, glob = _many_point_layout(c, n_end, w.element_size())
    # d = 3: the h chain in the kernel (hankel.cuh), on a real or complex k r;
    # else K5's h-only table, point chunk by point chunk
    rad = (2 if k.is_complex() else 1) if d == 3 else 0
    k = k.contiguous()
    per_point = n_k * n_b * n_end * (w.element_size() + x.element_size())
    chunk = max(1, _H_BYTES // per_point if not rad or glob else n_p)
    for s in range(0, n_p, chunk):
        xs = x[..., s : s + chunk]
        n_pc = xs.shape[-1]
        hm = he = xs  # not read by the chain
        if not rad:
            rel = xs[..., None] - centers.permute(2, 0, 1)[:, :, None, :]  # [d, K, Pc, B]
            hm, he = spherical_h_scaled(d, n_end, k[:, None, None] * tree_radius(c, rel))
        # slices of the balls over the grid when the points alone give too
        # few CTAs: many-point mode, each slice writes its balls' fields;
        # few-point mode, one sum a slice; summed below
        ctas = n_pc * n_k if few else -(-n_pc // _THREADS) * n_k  # n_pc >= 1
        bpz = -(-n_b // min(n_b, -(-_FILL_CTAS // ctas)))
        n_slices = -(-n_b // bpz)
        dst = out[s : s + chunk]
        if n_slices > 1 and not per_ball:
            dst = torch.empty((n_pc, n_k, n_slices if few else n_b), dtype=cdt, device=x.device)
        sx = xs.stride()
        # the radial tables' scratch: n_end per thread of the grid
        hs = (torch.empty(n_end * ctas * _THREADS * n_slices, dtype=cdt, device=x.device)
              if glob and not few else None)
        kernels.launch(
            "bhs_harmonic_eval", xs, sx[0], sx[1], sx[2], n_kx, centers, centers.stride(0), rad,
            hm, he, k, _rescale_for(rdt), wp, prog.nodes, prog.jobs, prog.fam, prog.coef,
            prog.famr, prog.n_nodes, prog.cs, prog.csjob, dst, n_pc, n_k, n_b, n_end, h_num,
            prog.n_cs, d, prog.root_step, int(per_ball or (n_slices > 1 and not few)), int(few),
            bpz, _clamp_limit(rdt), wwin, hs, int(rdt == torch.float64))
        if n_slices > 1 and not per_ball:
            out[s : s + chunk] = dst.sum(-1)
        harmonic_eval.launches += 1
        harmonic_eval.few_launches += int(few)
    return out


harmonic_eval.launches = 0
harmonic_eval.few_launches = 0  # of them, launches in the few-point mode
