"""What the port's A/B tools share: the card's line, the warm-up, the
device's busy time under torch.profiler, and the runner in turns.

    python tools/ab_common.py PARENT_DIR TOOL [ARGS ...]

runs TOOL (a script under tools/, e.g. tools/torch_k6_ab.py) as
`python TOOL LABEL ARGS ...` in four fresh processes, in turns: from
PARENT_DIR (an unpacked parent tree, e.g. from `git archive`, in a
directory that .gitignore lists), from this tree, from this tree again and
from PARENT_DIR again, with LABEL `parent` or `this`.  TOOL and this
module are copied into PARENT_DIR first, so that one tool times both
trees' code (with each tree's own chip_smoke.py helpers).  Each run's
output is printed as it ends; the exit code is the first non-zero one of
the four.
"""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_events(prof):
    """The device (CUDA) events of a torch.profiler run."""
    return [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]


def busy_us(prof):
    """(the union of the device events' intervals in microseconds, their
    count); the idle share of a wall of w seconds is 1 - busy * 1e-6 / w."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events(prof))
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, len(spans)


def warm_up(torch):
    """Build and load the kernels, then solve the bench's 16 spheres ('ba')
    at n_end = 4 and k = 1 on card 0."""
    import chip_smoke as cs
    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops import kernels

    kernels.library()
    f = dict(dtype=torch.float32, device=torch.device("cuda", 0))
    uin, _ = plane_wave(k=torch.tensor(1.0, **f), direction=torch.tensor([1.0, 0.0, 0.0], **f))
    biem(create_from_branching_types("ba"), centers=torch.as_tensor(cs.lattice_centers(), **f),
         radii=torch.ones(16, **f), k=torch.tensor(1.0, **f), n_end=4, uin=uin)
    torch.cuda.synchronize()


def main():
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, tool, args = Path(sys.argv[1]).resolve(), Path(sys.argv[2]), sys.argv[3:]
    for rel in (tool, Path("tools/ab_common.py")):
        (parent / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(ROOT / rel, parent / rel)
    rc = 0
    for label, tree in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        run = subprocess.run([sys.executable, str(tool), label, *args], cwd=tree,
                             capture_output=True, text=True)
        print(f"--- {label} ({tree}) rc={run.returncode}", flush=True)
        print(run.stdout, end="", flush=True)
        if run.returncode:
            print(run.stderr[-4000:], end="", flush=True)
        rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
