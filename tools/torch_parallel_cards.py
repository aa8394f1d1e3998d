"""parallel/ across several cards: NCCL ranks, one a card, at full width.

    python tools/torch_parallel_cards.py [N]

Run from the repository root on a machine with N >= 2 CUDA cards and nvcc
(no JAX needed; N defaults to every card).  It builds the kernels once,
then spawns N NCCL ranks (rank r on cuda:r) that run chip_smoke.py phase
12's paths (`chip_smoke.sharded_paths`: the bench sweep in complex64 and
the points at 131,072, then in complex128 the dense solve at n_end=19
through KD's row window, the offset table at the bench and the 32 x 32
'ba' lattice at n_end=19), and on cuda:0 their single-card references:
`biem()` on the 8 ks in one call (the sweep, 1e-4 relative), dense GMRES
(1e-8 of the largest entry), the single-card offset table (1e-10) and the
lattice route's complex128 solve (1e-10).  Every rank must hold the same
bits and at most 0.55 of the whole operator; it prints each rank's
seconds per path split into compute and collectives, its operator bytes
and its peak device memory, beside the card's name and power limit.  It
exits non-zero if a check fails.
"""

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the phase-12 paths and helpers)
from tools.ab_common import card_line  # noqa: E402


def rank_main(rank, world, device, out_dir):
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    out = chip_smoke.sharded_paths(torch, dev, world, "cuda", stats)
    torch.save({"out": out, "stats": stats, "peak": torch.cuda.max_memory_allocated(),
                "device": dev.index}, os.path.join(out_dir, f"rank{rank}.pt"))


def main():
    import torch

    from biem_helmholtz_sphere_tpu_torch import biem, plane_wave
    from biem_helmholtz_sphere_tpu_torch.coords import create_from_branching_types
    from biem_helmholtz_sphere_tpu_torch.ops import kernels
    from biem_helmholtz_sphere_tpu_torch.parallel._dryrun import spawn_ranks

    if not torch.cuda.is_available():
        print("torch_parallel_cards: CUDA is not available", file=sys.stderr)
        return 2
    world = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    if world < 2 or world > torch.cuda.device_count():
        print(f"torch_parallel_cards: {world} ranks need as many cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    card = card_line()
    kernels.library()  # built once, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(rank_main, world, tmp, "cuda", tmp)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]
    if [r["device"] for r in ranks] != list(range(world)):
        raise RuntimeError(f"the ranks ran on cards {[r['device'] for r in ranks]}")
    for name in ("sweep", "points", "dense", "matfree", "lattice"):
        for r, res in enumerate(ranks[1:], 1):
            if not chip_smoke.same_bits(torch, res["out"][name], ranks[0]["out"][name]):
                raise RuntimeError(f"rank {r}'s {name} differs from rank 0's")

    dev = torch.device("cuda", 0)
    f = dict(dtype=torch.float32, device=dev)
    ba = create_from_branching_types("ba")
    centers = torch.as_tensor(chip_smoke.lattice_centers(), **f)
    nb = len(centers)
    ks = torch.as_tensor(chip_smoke.sweep_ks()[: 2 * chip_smoke.KB], **f)
    uin, _ = plane_wave(k=ks, direction=torch.tensor([1.0, 0.0, 0.0], **f)[:, None]
                        .expand(3, len(ks)))
    u = biem(ba, centers=centers.expand(len(ks), nb, 3), radii=torch.ones(len(ks), nb, **f),
             k=ks, n_end=chip_smoke.N_END, uin=uin).uscat(torch.zeros(3, 1, **f))[0].cpu()
    e_sweep = float(((ranks[0]["out"]["sweep"] - u).abs() / u.abs()).max())
    if not e_sweep <= chip_smoke.SHARDED_TOL["sweep"]:
        raise RuntimeError(f"the sweep is {e_sweep:.3e} from biem()'s")
    f64 = dict(dtype=torch.float64, device=dev)
    cen = chip_smoke.square_lattice(chip_smoke.N_SIDE_3D, 3)
    k1 = torch.tensor(1.0, **f64)
    uin, _ = plane_wave(k=k1, direction=torch.tensor([1.0, 0.0, 0.0], **f64))
    calc = biem(ba, centers=torch.as_tensor(cen, **f64), radii=torch.ones(len(cen), **f64),
                k=k1, n_end=chip_smoke.N_END_3D, uin=uin, stable=True)
    chip_smoke.SHARED["9a density"] = calc.density.cpu()
    del calc
    ref = chip_smoke.reference_densities(torch, dev)
    chip_smoke.check_densities(torch, ranks[0]["out"], ref, f"{world} NCCL ranks")
    for name in ("dense", "matfree", "lattice"):
        for r, res in enumerate(ranks):
            st = res["stats"][name]
            if not st["bytes"] <= 0.55 * st["whole_bytes"]:
                raise RuntimeError(f"rank {r}: {name} holds {st['bytes']} of "
                                   f"{st['whole_bytes']} bytes")
    print(f"{world} NCCL ranks, one a card: the sweep within {e_sweep:.2e} of biem(), every "
          "rank bit for bit rank 0; per-rank operator bytes (of the whole): " + ", ".join(
              f"{n} {ranks[0]['stats'][n]['bytes'] / 2**20:.1f} MiB "
              f"({ranks[0]['stats'][n]['bytes'] / ranks[0]['stats'][n]['whole_bytes']:.3f})"
              for n in ("dense", "matfree", "lattice"))
          + "; per-rank peak " + " / ".join(f"{res['peak'] / 2**30:.3f} GiB" for res in ranks))
    for r, res in enumerate(ranks):
        print(f"rank {r}'s split, s per call: {chip_smoke.format_comm_split(res['stats'])} "
              f"({card})")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
