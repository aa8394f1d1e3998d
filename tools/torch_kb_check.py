"""KB's row panels on the card, and the 3D bench's KB products against a
parent checkout's kernel, bit for bit and timed.

    python tools/torch_kb_check.py [--parent DIR]

Run from the repository root on a machine with a CUDA card and nvcc (no
JAX needed).  It builds the kernels, then:

- holds `block_diag_cmm` in its row-panel mode (D's degree blocks of a
  d >= 4 tree too large to stage whole) against its plain version, D^H
  and D in complex64 and complex128, each launched twice and required bit
  for bit equal, with its mean milliseconds around the wrapper: the 4D
  hypercube {-2, 2}^4 at n_end 20, 16 and 11, and the 5D pair at n_end 8
  (4 k on the factored route's compacted lanes, random D);
- with --parent DIR (an unpacked checkout of another commit, e.g. `git
  archive` into a directory under build/), runs the 3D bench's three KB
  products (4 k, the 240 compacted lanes, random D and X from one seed)
  with DIR's package and this one in separate processes, in turns
  (parent, this, this, parent), and requires this one's outputs to equal
  the parent's bit for bit; it prints each run's mean milliseconds.

It exits non-zero if a check fails.
"""

import argparse
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lattice():
    g = (np.arange(4) - 1.5) * 4.0
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((16, 3))
    centers[:, 0], centers[:, 1] = xx.ravel(), yy.ravel()
    return centers


def setup(root):
    sys.path.insert(0, root)
    import torch

    from biem_helmholtz_sphere_tpu_torch.ops import kernels

    kernels.library()
    return torch, torch.device("cuda")


def randc(torch, rng, shape, cdt, dev):
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return torch.as_tensor(z, dtype=cdt, device=dev)


def mean_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_products(root, out):
    """The 3D bench's D^H, X, D with `root`'s package, saved to `out`."""
    torch, dev = setup(root)
    from biem_helmholtz_sphere_tpu_torch.biem._core import _pair_routing
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
        LaneSegments, block_diag_cmm, pack_layout)
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import _child_state_blocks

    c = create_from_branching_types("ba")
    rt = _pair_routing(lattice())
    cs_sizes, cs_perm = _child_state_blocks(c, 32)
    d_seg = LaneSegments(tuple(int(v) for v in rt.slot_ptr))
    x_seg = LaneSegments(tuple(int(v) for v in rt.rad_ptr))
    res = {}
    for cdt in (torch.complex64, torch.complex128):
        rng = np.random.default_rng(7)
        d = pack_layout(2 * np.arange(32) + 1, None, 1024, dev)
        d = replace(d, vals=randc(torch, rng, (len(rt.uniq), d.rows.numel()), cdt, dev))
        x = pack_layout(cs_sizes, cs_perm, 1024, dev)
        x = replace(x, vals=randc(torch, rng, (4, len(rt.uniq_r), x.rows.numel()), cdt, dev))
        lanes = randc(torch, rng, (4, len(rt.src), 1024), cdt, dev)
        for name, fn in (("D^H", lambda: block_diag_cmm(d, lanes, d_seg, adjoint=True)),
                         ("X", lambda: block_diag_cmm(x, lanes, x_seg)),
                         ("D", lambda: block_diag_cmm(d, lanes, d_seg))):
            key = f"{name} {str(cdt).split('.')[-1]}"
            res[key] = (fn().cpu(), mean_ms(torch, fn))
    torch.save(res, out)


def panels(torch, dev):
    """KB's row-panel mode against its plain version; returns failures."""
    from biem_helmholtz_sphere_tpu_torch.biem._core import _pair_routing
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import harm_n_ndim
    from biem_helmholtz_sphere_tpu_torch.ops.block_diag import (
        LaneSegments, _block_diag_cmm_plain, block_diag_cmm, pack_layout, unpack)

    cube = np.stack(np.meshgrid(*([[-2.0, 2.0]] * 4), indexing="ij"), axis=-1).reshape(-1, 4)
    pair5 = np.zeros((2, 5))
    pair5[0, 1], pair5[1, 1] = 2.0, -2.0
    fails = []
    for label, d, n_end, centers in (("4D n_end 20", 4, 20, cube), ("4D n_end 16", 4, 16, cube),
                                     ("4D n_end 11", 4, 11, cube), ("5D n_end 8", 5, 8, pair5)):
        rt = _pair_routing(centers)
        sizes = [harm_n_ndim(n, d) for n in range(n_end)]
        h = sum(sizes)
        seg = LaneSegments(tuple(int(v) for v in rt.slot_ptr))
        for cdt in (torch.complex64, torch.complex128):
            rng = np.random.default_rng(3)
            a = pack_layout(sizes, None, h, dev)
            a = replace(a, vals=randc(torch, rng, (len(rt.uniq), a.rows.numel()), cdt, dev))
            lanes = randc(torch, rng, (4, len(rt.src), h), cdt, dev)
            dense = unpack(a)
            for adj in (True, False):
                n0 = block_diag_cmm.panel_launches
                got = block_diag_cmm(a, lanes, seg, adjoint=adj)
                again = block_diag_cmm(a, lanes, seg, adjoint=adj)
                paneled = block_diag_cmm.panel_launches - n0 == 2
                ref = _block_diag_cmm_plain(dense, lanes, seg, adj)
                err = float((got - ref).abs().max() / ref.abs().max())
                same = torch.equal(torch.view_as_real(got), torch.view_as_real(again))
                ms = mean_ms(torch, lambda: block_diag_cmm(a, lanes, seg, adjoint=adj), 10)
                name = f"{label} {str(cdt).split('.')[-1]} {'D^H' if adj else 'D'}"
                print(f"{name}: rel err {err:.3e}, repeat equal {same}, panels {paneled}, "
                      f"kernel {ms:.4f} ms", flush=True)
                tol = 1e-5 if cdt == torch.complex64 else 1e-12
                if not (err <= tol and same and paneled):
                    fails.append(name)
            del a, lanes, dense
            torch.cuda.empty_cache()
    return fails


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked checkout to compare the 3D bench with")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kb_check: CUDA is not available", file=sys.stderr)
        return 2
    torch, dev = setup(ROOT)
    fails = panels(torch, dev)
    if args.parent:
        runs = []
        for tag, root in (("parent", args.parent), ("this", ROOT), ("this", ROOT),
                          ("parent", args.parent)):
            out = os.path.join(ROOT, "build", f"kb_check_{len(runs)}.pt")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            # this script's bench_products on `root`'s package, in a process
            # of its own (the parent may predate this script)
            subprocess.run([sys.executable, "-c",
                            f"import sys; sys.path.insert(0, {os.path.dirname(__file__)!r}); "
                            f"import torch_kb_check as k; k.bench_products({root!r}, {out!r})"],
                           check=True)
            runs.append((tag, torch.load(out)))
        for key in runs[0][1]:
            same = all(torch.equal(torch.view_as_real(r[key][0]),
                                   torch.view_as_real(runs[0][1][key][0])) for _, r in runs)
            print(f"3D bench {key}: equal to the parent's bits {same}; mean ms "
                  + ", ".join(f"{tag} {r[key][1]:.4f}" for tag, r in runs))
            if not same:
                fails.append(f"3D bench {key}")
    print("failures:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
