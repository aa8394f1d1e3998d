"""Profile the port's bench sweep on the card: device time per kernel and
the device's idle share.

    python tools/torch_profile_sweep.py

Run from the repository root on a machine with a CUDA card (no JAX
needed).  It drives chip_smoke.py's bench sweep (`chip_smoke.bench_sweep`: 16 unit
spheres on a 4x4 lattice, n_end=32, complex64, 8 k in blocks of 4 with
warm starts) once to warm up and once under torch.profiler, then prints:

- the card's name and power limit;
- the wall time of the profiled sweep and the device's busy time (the
  union of the intervals in which any kernel ran), hence its idle share;
- the device time of each kernel name, largest first, with its count.

Numbers from a profiled run include the profiler's own overhead on the
host; compare device times, not the wall time, with unprofiled runs.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _device_time(evt):
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _busy_us(prof):
    """Union of the device kernels' intervals, in microseconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    )
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


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import bench_sweep

    if not torch.cuda.is_available():
        print("torch_profile_sweep: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _, sweep, ks = bench_sweep(torch, torch.device("cuda", 0))

    sweep()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, n_kernels = _busy_us(prof)
    print(f"card: {card}")
    print(f"profiled sweep of {len(ks)} k: wall {wall:.6f} s, device busy "
          f"{busy_us * 1e-6:.6f} s over {n_kernels} device events, idle share "
          f"{1.0 - busy_us * 1e-6 / wall:.4f}")
    rows = [(e.key, _device_time(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    print("device time by name (ms total, count, us per call):")
    for key, t_us, n in rows[:25]:
        print(f"  {t_us * 1e-3:10.4f} ms  {n:6d}  {t_us / max(n, 1):9.2f} us  {key[:90]}")
    print("the port's own kernels (csrc/):")
    for key, t_us, n in rows:
        if "(anonymous namespace)::" in key:
            print(f"  {t_us * 1e-3:10.4f} ms  {n:6d}  {t_us / max(n, 1):9.2f} us  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
