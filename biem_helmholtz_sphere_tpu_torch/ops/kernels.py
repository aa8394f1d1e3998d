"""Build and load the hand-written CUDA kernels of the port.

The sources under `csrc/*.cu` expose a plain C interface and are compiled
at first use with `nvcc` for Hopper (sm_90a), one `nvcc` per source, all
started together, then linked into one shared library under
`build/kernels/` at the repository root and loaded with ctypes.  The
library name carries a hash of the sources and flags, so an edit rebuilds
it.  Nothing here runs at import: the CPU tests import every module on a
machine without `nvcc` or a card.

There is no fallback: a missing compiler, a failed build or a kernel that
reports a CUDA error raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("fused_ba_eval.cu", "block_diag_cmm.cu", "lane_route.cu",
           "spherical_jh.cu", "coax_fold.cu", "dense_assemble.cu", "graf_fold.cu",
           "band_sr.cu", "harmonic_eval.cu", "rotation_blocks.cu", "coax_u.cu",
           "gmres_step.cu", "plane_rhs.cu")
HEADERS = ("common.cuh", "mma_f64.cuh", "harmonics.cuh", "harmonic_walk.cuh", "hankel.cuh")
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# C entry points: name -> argtypes (every entry returns a cudaError_t)
_SIGNATURES = {
    # x, sx_d, sx_k, sx_p, kx, centers, sc_k, k, ck, w2, coef_ab, coef_b1,
    # coef_bb, p0, out, P, K, B, n, far, per_ball, few, lim, rescale, dbl,
    # stream
    "bhs_fused_ba_eval": [_P, _L, _L, _L, _I, _P, _L, _P, _I, _P, _P, _P, _P,
                          _P, _P, _I, _I, _I, _I, _I, _I, _I, _D, _D, _I, _P],
    # vals, offs, sizes, voffs, perm, items, n_items, x, y, nnz, L, H,
    # buf_elems, adjoint, dbl, stream
    "bhs_block_diag_cmm": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                           _I, _I, _I, _P],
    # x, blc, pm, src_ptr, src_lane, lanes, K, B, L, H, dbl, stream
    "bhs_lane_gather": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # y, x, diag, reg, pm, csr_ptr, csr_lane, csr_dn, out, K, B, L, H,
    # dbl, stream
    "bhs_lane_scatter": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _P],
    # z, out, N, n_end, base, m, mode, d, cyl, cyl_len, c_d, rescale,
    # inv_rescale, log_rescale, dbl, stream
    "bhs_spherical_jh": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _D, _D, _D, _D,
                         _I, _P],
    # radm, rade, iazf, u_tiles, units, order, e_r, e_b, out, P, n_rad, nb,
    # ng, nnz, n_units, unit_slabs, L, dbl, stream
    "bhs_coax_fold": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _P],
    # table, pairs, pairs_k, rowf, colf, sgn, diag, out, K, B, NO, H,
    # n_pairs, n_tiles, s_b, s_bp, s_h, s_k, r0, r1, vec, dbl, stream
    "bhs_dense_assemble": [_P, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _L, _L, _L, _L, _L, _L, _I, _I, _P],
    # tab, etab, theta, theta_k, m_out, m_in, e_r, e_b, out, K, NO, NMU, Ho,
    # Hi, rows, smem, scale, fold, dbl, stream
    "bhs_graf_fold": [_P, _P, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _D, _I, _I, _P],
    # coef, t_hat, t_k, w, s_cart, F, ko0, G, NO, d, Q, Qp, NB, nu, dbl, stream
    "bhs_band_f": [_P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _D, _I, _P],
    # F, yo, yi, n_o, n_i, row_plan, he, e_r, e_b, out, ko0, G, NO, Q, Qp, Ho,
    # Hi, Hop, Hip, NB, n_slots, w_max, fold, dbl, stream
    "bhs_band_sr": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, sxd, sxk, sxp, kx, centers, sck, rad, hm, he, k, rescale, w, ke_perm,
    # nodes, jobs, fam, coef, famr, n_nodes, shape, walk, wfam, wroot, wstep,
    # wjob, runs, out, P, K, B, n, H, n_cs, d, root_step, per_ball, few, bpz,
    # lim, wwin, threads, pt, wpb, hs_glob, dbl, stream
    "bhs_harmonic_eval": [_P, _L, _L, _L, _I, _P, _L, _I, _P, _P, _P, _D, _P, _P, _P, _P, _P,
                          _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _D, _I, _I, _I, _I, _P, _I, _P],
    # shape, rad, threads, pt, n_end, wwin, glob, dbl, &blocks (no stream)
    "bhs_harmonic_eval_occupancy": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    # ycw, s_cart, rot, nodes, jobs, fam, coef, famr, n_nodes, cs, csjob, perm,
    # n_cs, blocks, desc, n_cta, harm, slab, grp, packed, N, Q, Qp, hp, H, d,
    # nnz, dbl, stream
    "bhs_rotation_blocks": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _I,
                            _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _P],
    # t, tzw, rows, cols, order, tiles, u, u_img, where, q, nb, nnz, n_tiles,
    # ng, direct, smem, dbl, stream
    "bhs_coax_u": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _P],
    # V, R, g, Q, resid, steps, flag, w, diag, target, cwork, rwork, K, n, m,
    # j, grid, per_round, unit, lmax, cw, rb, stages, resident_rows,
    # max_pieces, x_smem, boxes, smem, tiny, dbl, stream
    "bhs_arnoldi_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _D, _I, _P],
    # dbl, out int [3] (no stream)
    "bhs_arnoldi_capacity": [_I, _P],
    # R, g, flag, y, K, m, tiny, dbl, stream
    "bhs_gmres_backsolve": [_P, _P, _P, _P, _I, _I, _D, _I, _P],
    # pack (csrc/plane_rhs.cu's slots: ops/plane_rhs.py _SLOTS), out, j, jp,
    # k, dir, centers, alpha, beta, stream
    "bhs_plane_rhs": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
}

# the real dtype of each complex dtype the kernels take
REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}

# P * K below this takes KA's and KE's few-point mode: fewer (point, k)
# pairs than 4 per SM of a 132-SM H100 cannot fill the card one point per
# thread
FEW_POINTS = 4 * 132

_lock = threading.Lock()
_lib = None


def default_device():
    """The device of an entry point given no tensor: the card.

    The port runs on the card unless the caller asks for the CPU (CPU
    tensors, or device="cpu"); without CUDA this raises instead of
    carrying on quietly on the CPU.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card unless the caller "
            "asks for the CPU (pass CPU tensors, or device='cpu')"
        )
    return torch.device("cuda")


def as_tensors(*xs):
    """xs as tensors on one device: the first tensor's, or the card
    (`default_device`) when none is a tensor.  A Python or numpy number
    keeps numpy's float64 / complex128 (torch.as_tensor would make a
    Python float float32); None stays None."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    dev = default_device() if dev is None else dev
    return tuple(
        None if x is None else x.to(dev) if isinstance(x, torch.Tensor)
        else torch.as_tensor(np.asarray(x), device=dev)
        for x in xs
    )


def _nvcc():
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): the "
            "port's CUDA kernels cannot be built"
        )
    return cand


def library_path():
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + ("-Xptxas", "-v")).encode())
    return BUILD_DIR / f"libbhs_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Start every command at once, wait for all; raise if any failed,
    else return each command's standard error."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed, errs = [], []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        errs.append(stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


def ptxas_path(source, lib=None):
    """Where `build` keeps ptxas's report (-Xptxas -v: registers, shared
    memory, spills of each kernel) for `source` of the library `lib`."""
    lib = library_path() if lib is None else lib
    return lib.with_name(f"{lib.stem}.{Path(source).stem}.ptxas.txt")


def build():
    """Compile the sources (if this exact build is missing); return the path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{Path(s).stem}.{os.getpid()}.o") for s in SOURCES]
    errs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(CSRC / s)]
                     for s, o in zip(SOURCES, objs)])
    for s, err in zip(SOURCES, errs):
        ptxas_path(s, out).write_text(err)
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def current_stream_handle(index=None):
    """The current stream's handle on device `index` (default: the current
    device), as torch.cuda.current_stream(index).cuda_stream gives it,
    without building a Stream object (the query torch's own generated
    kernels launch with)."""
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _device_error(name, operands):
    """Raise for kernel operands that lie on different devices (a kernel
    reads every pointer on one card) or off the card."""
    devs = sorted({str(t.device) for t in operands})
    if len(devs) != 1:
        raise RuntimeError(f"{name}: operands lie on different devices {devs}")
    raise RuntimeError(f"{name}: unsupported device {devs[0]}")


def launch(name, *args):
    """Call C entry `name` with `args`, each tensor passed by its address
    (the wrapper has made it contiguous, or passes its strides), on the
    current stream of the tensors' device, with that device current; raise
    if they lie on different devices or the kernel reports a CUDA error."""
    cargs, index = [], None
    for a in args:
        if isinstance(a, torch.Tensor):
            i = a.get_device()  # -1 off the card; cheaper than .device
            if i != index:
                if index is not None or i < 0:  # two devices, or not CUDA
                    _device_error(name, [t for t in args if isinstance(t, torch.Tensor)])
                index = i
            a = a.data_ptr()
        cargs.append(a)
    if index is None:
        raise RuntimeError(f"{name}: no tensor operands")
    fn = getattr(library(), name)
    if index == torch.cuda.current_device():
        err = fn(*cargs, current_stream_handle(index))
    else:
        with torch.cuda.device(index):
            err = fn(*cargs, current_stream_handle(index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
