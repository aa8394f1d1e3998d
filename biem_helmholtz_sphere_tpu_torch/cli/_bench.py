"""`bench` subcommand: assembly + solve wall time per k-point of the port's
`biem()` on one device (host clock around work that ends in a device
synchronization), optionally under `torch.profiler`."""

import logging
import os
import time

import torch

log = logging.getLogger(__name__)


def run_bench(n_end=16, n_side=2, k=4.0, profile=None, device=None):
    """Time the float32 'ba' solve of an n_side x n_side lattice: the first
    call (the kernels' load included) apart, then 3 k-points.  profile: a
    directory for a torch.profiler trace of the 3 timed solves.  Returns
    the seconds per k-point."""
    from ..biem import biem, plane_wave
    from ..coords import create_from_branching_types
    from ._accuracy import host_dev, lattice_centers, resolve

    dev, rdt = resolve(device, "float32")
    c = create_from_branching_types("ba")
    centers = torch.as_tensor(lattice_centers(n_side, 3), dtype=rdt, device=dev)
    radii = torch.ones(n_side * n_side, dtype=rdt, device=dev)
    direction = torch.tensor([1.0, 0.0, 0.0], dtype=rdt, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(kk):
        kk = torch.tensor(kk, dtype=rdt, device=dev)
        uin, _ = plane_wave(k=kk, direction=direction)
        return biem(c, centers=centers, radii=radii, k=kk, n_end=n_end, uin=uin).density

    t0 = time.perf_counter()
    step(k)
    sync()
    first_s = time.perf_counter() - t0
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = torch_profile(activities=acts)
        prof.__enter__()
    reps = 3
    t0 = time.perf_counter()
    for i in range(reps):
        step(k + 0.01 * (i + 1))
    sync()
    per_solve = (time.perf_counter() - t0) / reps
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(profile, exist_ok=True)
        path = os.path.join(profile, "bench_trace.json")
        prof.export_chrome_trace(path)
        log.info("wrote torch.profiler trace to %s", path)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(
        f"device={host_dev(dev)} ({name}) B={n_side**2} n_end={n_end} k={k}: "
        f"first call {first_s:.1f}s, assembly+solve {per_solve:.4f}s per k-point"
    )
    return per_solve
