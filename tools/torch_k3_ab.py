"""K3 (`rotation_blocks`) at chip_smoke.py's three K3 shapes, on one card.

    python tools/torch_k3_ab.py LABEL        # this tree's K3, timed
    python tools/torch_k3_ab.py --profile    # its device time by kernel

Run from the repository root on a machine with a CUDA card and nvcc (no
JAX needed).  The shapes: (i) 'bba' on the hypercube {-2, 2}^4 at
n_end = 20, its 64 slot directions (phase 8 (a)); (ii) 'ba' at the bench,
n_end = 32, its 36 slots (phase 4); (iii) 'ba' on the 32 x 32 lattice at
n_end = 19, its half table's 1,984 directions (phase 9 (a)); complex64 and
complex128.

- LABEL: the median ms of 5 calls after one, between CUDA events
  (`chip_smoke.cuda_ms`), printed after LABEL.  It reads nothing but
  `rotation_blocks` and chip_smoke.py's shapes, so a copy run from an
  unpacked parent tree times the parent's K3: run parent, this, this,
  parent in one call.
- --profile: the device microseconds of one call by kernel name
  (torch.profiler), its K3 kernels and the allocator's fills.
Source variants of K3 are timed in turns by `tools/torch_kernel_ab.py -k
K3 DIR...` at the same shapes.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def shapes(torch, dev, rdt):
    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch.biem._core import _offsets, _pair_routing
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types

    out = {}
    for name, tree, n_end, t in (
            ("(i) 4d", "bba", 20, _pair_routing(cs.hypercube_centers()).uniq),
            ("(ii) bench36", "ba", 32, _pair_routing(cs.lattice_centers()).uniq),
            ("(iii) lat1984", "ba", 19, _offsets(cs.square_lattice(32, 3))[0])):
        t = torch.as_tensor(t, dtype=rdt, device=dev)
        out[name] = (create_from_branching_types(tree), t / t.norm(dim=-1, keepdim=True), n_end)
    return out


def main():
    import torch

    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch.translation import _rotation as rot

    if not torch.cuda.is_available():
        print("torch_k3_ab: CUDA is not available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    dtypes = (torch.float32, torch.float64)

    if args == ["--profile"]:
        from torch.profiler import ProfilerActivity, profile

        for rdt in dtypes:
            for name, a in shapes(torch, dev, rdt).items():
                rot.rotation_blocks(*a)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    rot.rotation_blocks(*a)
                    torch.cuda.synchronize()
                rows = sorted(((e.key[:60], e.count, e.device_time_total)
                               for e in prof.key_averages() if e.device_time_total > 0),
                              key=lambda r: -r[2])
                print(name, rdt, [(k, c, round(v, 1)) for k, c, v in rows[:6]], flush=True)
        return 0

    print(args[0], {f"{name} {str(rdt)[6:]}": round(
        cs.cuda_ms(torch, lambda: rot.rotation_blocks(*a), 5), 4)
        for rdt in dtypes for name, a in shapes(torch, dev, rdt).items()}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
