"""KE (`harmonic_eval`) at chip_smoke.py's four KE shapes, on one card.

    python tools/torch_ke_ab.py LABEL        # this tree's KE, timed
    python tools/torch_ke_ab.py --profile    # its device time by kernel
    python tools/torch_ke_ab.py --sass       # its instances' registers and local memory
    python tools/torch_ke_ab.py --host LABEL # the wrapper's host time per call

Run from the repository root on a machine with a CUDA card and nvcc (no
JAX needed).  The shapes, with the inputs chip_smoke.py's phase 2
(`check_ke`) makes: (i) 'bpa' at the bench (16 spheres), n_end = 32,
131,072 points x 1 k (the many-point mode); (ii) 'bba' on the hypercube
{-2, 2}^4, n_end = 20, 16,384 points; (iii) 'a' on the 64 x 64 circles,
n_end = 32, 1 point (the few-point mode); (iv) 'caa' on the hypercube,
n_end = 14, 1 point x 4 k; complex64 and complex128.

- LABEL: the median ms of 5 calls after one (25 at the one-point shapes,
  whose time is the host's and spreads), between CUDA events
  (`chip_smoke.cuda_ms`), around the wrapper (in d != 3 K5's h table and
  the host work included), printed after LABEL.  It reads nothing but
  `harmonic_eval` and chip_smoke.py's shapes, so a copy run from an
  unpacked parent tree times the parent's KE: run parent, this, this,
  parent in one call.
- --profile: the device microseconds of one call by kernel name
  (torch.profiler): KE's kernel, K5's and the cylinder seeds' kernels.
- --host LABEL: the host time of one call (the wrapper's enqueue, the card
  idle before it: perf_counter, fastest and median of 50 after a warm-up),
  what the one-point shapes' time is made of; copyable as LABEL is.
- --sass: for every KE kernel instance in the built library, its
  registers, stack frame and spill bytes (the build's ptxas -v report) and
  its local-memory instructions (LDL / STL in cuobjdump's SASS) in all and
  inside an inner loop (one that holds no other) that does floating-point
  work (FFMA / DFMA: the root's recurrence, the walk's steps), with those
  loops' extents and FMA counts.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def shapes(torch, dev, cdt):
    """{name: (tree, n_end, x, centers, k, w)} as chip_smoke's check_ke makes them."""
    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis

    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
    out = {}
    for name, tree, n_end, centers_np, n_p, n_k in (
            ("(i) bpa", "bpa", cs.N_END, cs.lattice_centers(), cs.EVAL_POINTS, 1),
            ("(ii) bba", "bba", cs.N_END_4D, cs.hypercube_centers(), cs.EVAL_POINTS_4D, 1),
            ("(iii) a", "a", cs.LADDER_2D[-1], cs.square_lattice(cs.N_SIDE_2D, 2), 1, 1),
            ("(iv) caa", "caa", cs.N_END_C, cs.hypercube_centers(), 1, cs.KB)):
        c = create_from_branching_types(tree)
        d, nb = c.c_ndim, len(centers_np)
        ell = basis(c, n_end).n_root
        rng = np.random.default_rng(77)
        f = dict(dtype=rdt, device=dev)
        cen = torch.as_tensor(centers_np, **f).expand(n_k, nb, d)
        x = torch.as_tensor(rng.normal(size=(d, 1, n_p)) * (20.0 if n_p > 1 else 0.0), **f)
        k = torch.as_tensor(np.linspace(7.0, 7.06, n_k), **f)
        w = cs.randc(torch, rng, (n_k, nb, len(ell)), cdt, dev) * torch.as_tensor(np.exp(-ell), **f)
        out[name] = (c, n_end, x, cen, k, w)
    return out


def ptxas_report(source):
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from the ptxas -v report the build keeps for `source`."""
    from biem_helmholtz_sphere_tpu_torch.ops import kernels

    out, prop = {}, None
    for ln in kernels.ptxas_path(source).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            out[m.group(1)] = {}
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            prop = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m and prop in out:
            out[prop].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and prop in out:
            out[prop]["registers"] = int(m.group(1))
    return out


def sass_functions():
    """{mangled name: SASS text} of the built library (cuobjdump -sass)."""
    from biem_helmholtz_sphere_tpu_torch.ops import kernels

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(kernels.library_path())], capture_output=True,
                          text=True, check=True).stdout
    return {f.split("\n", 1)[0].strip(): f for f in sass.split("Function : ")[1:]}


def local_memory(func):
    """(LDL / STL in all, in an inner loop with FFMA / DFMA work, [(first,
    last address, FMAs) of the inner loops with such work]) of one
    function's SASS: a loop is the span from a backward branch's target to
    the branch, an inner loop one that holds no other."""
    ins = [(int(a, 16), t) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;/]*);", func)]
    spans = []
    for addr, text in ins:
        m = re.search(r"\bBRA\s+0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            spans.append((int(m.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in spans
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans)]
    loops = []
    for lo, hi in inner:
        fma = sum(bool(re.search(r"\b[DF]FMA\b", t)) for a, t in ins if lo <= a <= hi)
        if fma:
            loops.append((lo, hi, fma))
    local = [a for a, t in ins if re.search(r"\b(LDL|STL)\b", t)]
    return len(local), sum(any(lo <= a <= hi for lo, hi, _ in loops) for a in local), loops


def instance_name(mangled):
    """harmonic_eval[_few]_kernel<T, R[, PT], S[, GLOB]> from a mangled name."""
    m = re.search(r"(harmonic_eval_(?:few_)?kernel)I(\w)((?:L[ib]\d+E)+)", mangled)
    if not m:
        return None
    args = [v if k == "i" else ("false", "true")[int(v)]
            for k, v in re.findall(r"L([ib])(\d+)E", m.group(3))]
    return f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}, {', '.join(args)}>"


def main():
    import torch

    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch.ops.harmonic_eval import harmonic_eval

    if not torch.cuda.is_available():
        print("torch_ke_ab: CUDA is not available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    dtypes = (torch.complex64, torch.complex128)

    if args == ["--sass"]:
        from biem_helmholtz_sphere_tpu_torch.ops import kernels

        kernels.library()
        report = ptxas_report("harmonic_eval.cu")
        for mangled, func in sass_functions().items():
            name = instance_name(mangled)
            if name is None:
                continue
            n_all, n_loop, held = local_memory(func)
            print(f"{name}: {report.get(mangled)}; LDL/STL {n_all}, in inner FMA loops {n_loop} "
                  f"(inner FMA loops: {held})", flush=True)
        return 0

    if args[:1] == ["--host"] and len(args) == 2:
        import statistics
        import time

        out = {}
        for cdt in dtypes:
            for name, a in shapes(torch, dev, cdt).items():
                harmonic_eval(*a)
                times = []
                for _ in range(50):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    harmonic_eval(*a)
                    times.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                out[f"{name} {str(cdt)[6:]}"] = (round(min(times), 4),
                                                 round(statistics.median(times), 4))
        print(args[1], "host ms (fastest, median)", out, flush=True)
        return 0

    if args == ["--profile"]:
        from torch.profiler import ProfilerActivity, profile

        for cdt in dtypes:
            for name, a in shapes(torch, dev, cdt).items():
                harmonic_eval(*a)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    harmonic_eval(*a)
                    torch.cuda.synchronize()
                rows = sorted(((e.key[:60], e.count, e.device_time_total)
                               for e in prof.key_averages() if e.device_time_total > 0),
                              key=lambda r: -r[2])
                total = sum(r[2] for r in rows)
                print(name, str(cdt)[6:], round(total, 2),
                      [(k, c, round(v, 2)) for k, c, v in rows[:8]], flush=True)
        return 0

    print(args[0], {f"{name} {str(cdt)[6:]}": round(
        cs.cuda_ms(torch, lambda: harmonic_eval(*a), 5 if a[2].shape[-1] > 1 else 25), 4)
        for cdt in dtypes for name, a in shapes(torch, dev, cdt).items()}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
