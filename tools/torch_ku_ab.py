"""The coax tables' cold build, split by stage, on one card.

    python tools/torch_ku_ab.py LABEL

Run from the repository root on a machine with a CUDA card and nvcc (no
JAX needed).  In this fresh process, after a warm-up
(`ab_common.warm_up`: the kernels built and loaded, a small 'ba' solve),
it times with synchronising host timers
(`chip_smoke.split_stages`):

- phase 8 (a)'s first block, cold: 'bba' on the hypercube {-2, 2}^4,
  n_end = 20, complex64, the first 4 k of the 4D sweep, solver auto (the
  factored GMRES), `basis` at n_end warm as in chip_smoke.py; split into
  RHS, radial rows, coax and, of the coax, its tables and K5 (K2 is the
  rest: `coax_fold` counts its launches through its module's name, so it
  is not wrapped), D's build, GMRES, uscat(0);
- the float32 coax tables (those of the complex64 path) of 'ba' at
  n_end = 32 (the bench) and 64, built cold (`basis` at n_end warm).

The tables are split by whatever stages the tree under test has: the host
index and plan, the root tables on the card and KU (`_coax_plan_on`,
`_coax_tables_on`, `coax_u`), or the host numpy tables (`_coax_tables`,
which enumerate the basis at 2 n_end - 1) and, the rest of
`_coax_packed_on`, the host product, mask, tile fill and copies.  To time
the parent's in turns with this tree's (parent, this, this, parent):
`python tools/ab_common.py PARENT_DIR tools/torch_ku_ab.py`.  Prints the
card, then LABEL and one JSON object of seconds.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.ab_common import card_line, warm_up  # noqa: E402


def stages_of(mods):
    """The (module, attribute, label) stages that exist in this tree."""
    _core, _scaled = mods
    cand = [(_core, "_rhs_dispatch", "RHS"), (_core, "_radial_rows_scaled", "radial rows"),
            (_core, "coax_fold_packed", "coax"),
            (_scaled, "_coax_packed_on", "coax tables"),
            (_scaled, "_coax_plan_on", "host index and plan"),
            (_scaled, "_coax_tables_on", "root tables on the card"),
            (_scaled, "coax_u", "KU"),
            (_scaled, "_coax_tables", "host numpy tables"),
            (_scaled, "spherical_h_scaled", "K5"),
            (_core, "rotation_d", "D build"), (_core, "gmres_solve_op", "GMRES"),
            (_core.BIEMResultCalculator, "uscat", "uscat(0)")]
    return [s for s in cand if hasattr(s[0], s[1])]


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.biem import _core
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.harmonics._index import basis
    from biem_helmholtz_sphere_tpu_torch.translation import _scaled

    if not torch.cuda.is_available():
        print("torch_ku_ab: CUDA is not available", file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    f = dict(dtype=torch.float32, device=dev)

    def solve(tree, ks, centers, n_end):
        kt = torch.as_tensor(np.asarray(ks), **f)
        n_k, d = kt.numel(), tree.c_ndim
        direction = torch.zeros(d, n_k, **f)
        direction[0] = 1.0
        uin, _ = plane_wave(k=kt, direction=direction)
        calc = biem(tree, centers=torch.as_tensor(centers, **f).expand(n_k, len(centers), d),
                    radii=torch.ones(n_k, len(centers), **f), k=kt, n_end=n_end, uin=uin)
        return calc.uscat(torch.zeros(d, 1, **f))

    print(f"card: {card_line()}", flush=True)
    warm_up(torch)
    stages = stages_of((_core, _scaled))
    out = {}
    c4 = create_from_branching_types("bba")
    basis(c4, cs.N_END_4D)
    acc, total = cs.split_stages(torch, lambda: solve(c4, cs.sweep_ks_4d()[:cs.KB],
                                                      cs.hypercube_centers(), cs.N_END_4D), stages)
    out["4D first block"] = dict({k: round(v, 6) for k, v in acc.items()}, total=round(total, 6))
    c3 = create_from_branching_types("ba")
    for n_end in (cs.N_END, 64):
        basis(c3, n_end)
        acc, total = cs.split_stages(
            torch, lambda: _scaled._coax_packed(c3, n_end, torch.float32, dev), stages)
        out[f"'ba' n_end={n_end} tables"] = dict({k: round(v, 6) for k, v in acc.items()},
                                                total=round(total, 6))
    print(sys.argv[1], json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
