"""Where K2 (csrc/coax_fold.cu) spends its time on the card, CTA by CTA.

    python tools/torch_k2_trace.py

Run from the repository root on a machine with a CUDA card and nvcc (no
JAX needed).  It copies biem_helmholtz_sphere_tpu_torch/csrc/ to
build/k2_trace/, adds clock64() marks to coax_fold.cu (the prologue's end,
and for each of the first 8 tiles of a work unit: before and after the
wait for its U slabs, after its band loop, after its epilogue), builds it,
runs K2 at the bench k-block (chip_smoke.coax_args, complex64) and reads
warp 0's marks of every CTA back from the output (pair 0's values are not
stored in this copy, so its row holds the marks).  It prints the card,
the prologue's cycles, the band loop's cycles per slab and the epilogue's
and the gap's cycles per tile for each kind of unit (top group x tiles),
and a least-squares fit of each unit's tile loop as a slabs + b tiles:
b / a is the per-tile cost, in slabs, that translation/_scaled.py
_TILE_COST balances the units with.
"""

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.ab_common import card_line  # noqa: E402

MARKS = 36  # int64 per CTA: start-relative clocks, then top group and tiles
EDITS = (
    ("  const int4 unit = units[blockIdx.x];",
     "  long long tr[MARKS_];\n  for (int i = 0; i < MARKS_; ++i) tr[i] = 0;\n"
     "  tr[0] = clock64();\n  const int4 unit = units[blockIdx.x];"),
    ("    __syncthreads();\n\n    for (int tl = 0; tl < n_tiles; ++tl) {",
     "    __syncthreads();\n    tr[1] = clock64();\n\n    for (int tl = 0; tl < n_tiles; ++tl) {"),
    ("      mbar_wait(&bar[tl]);\n",
     "      if (tl < 8) tr[2 + 4 * tl] = clock64();\n      mbar_wait(&bar[tl]);\n"
     "      if (tl < 8) tr[3 + 4 * tl] = clock64();\n"),
    ("      // the phase and the fold factor; one store each\n",
     "      if (tl < 8) tr[4 + 4 * tl] = clock64();\n"
     "      // the phase and the fold factor; one store each\n"),
    ("          if (q < np && cur.dst[r] >= 0)\n",
     "          if (q < np && cur.dst[r] >= 0 && p0 + q > 0)\n"),
    ("            out[(size_t)(p0 + q) * nnz + cur.dst[r]] = cscale<T>(mant, f);\n"
     "        }\n      }\n    }\n  }\n}",
     "            out[(size_t)(p0 + q) * nnz + cur.dst[r]] = cscale<T>(mant, f);\n"
     "        }\n      }\n      if (tl < 8) tr[5 + 4 * tl] = clock64();\n    }\n  }\n"
     "  tr[34] = clock64();\n  if (threadIdx.x == 0) {\n"
     "    long long* d = reinterpret_cast<long long*>(out) + (size_t)blockIdx.x * MARKS_;\n"
     "    for (int i = 1; i < 35; ++i) d[i] = tr[i] ? tr[i] - tr[0] : -1;\n"
     "    d[0] = unit.z;\n    d[35] = n_tiles;\n  }\n}"),
)


def traced_copy():
    """build/k2_trace/: csrc with the marks in coax_fold.cu."""
    src = ROOT / "biem_helmholtz_sphere_tpu_torch" / "csrc"
    dst = ROOT / "build" / "k2_trace"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    text = (dst / "coax_fold.cu").read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"coax_fold.cu has changed: mark anchor not found once:\n{old}")
        text = text.replace(old, new.replace("MARKS_", str(MARKS)))
    (dst / "coax_fold.cu").write_text(text)
    return dst


def main():
    import numpy as np
    import torch

    from biem_helmholtz_sphere_tpu_torch.ops import kernels
    from biem_helmholtz_sphere_tpu_torch.translation._scaled import coax_fold
    from chip_smoke import coax_args

    if not torch.cuda.is_available():
        print("torch_k2_trace: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    vdir = traced_copy()
    kernels.CSRC, kernels.BUILD_DIR, kernels._lib = vdir, vdir / "out", None
    dev = torch.device("cuda", 0)
    args = coax_args(torch, dev, torch.float32)
    n_u = args[-1].units.shape[0]
    for _ in range(3):
        out = coax_fold(*args)
    torch.cuda.synchronize()
    d = torch.view_as_real(out).reshape(-1).view(torch.int64)[: n_u * MARKS].cpu().numpy()
    d = d.reshape(n_u, MARKS)
    print(f"card: {card}; K2 at 4 k x 9 radii, complex64, {n_u} CTAs; clock64 cycles, warp 0")
    print(f"prologue: median {np.median(d[:, 1]):.0f} max {d[:, 1].max()}; "
          f"end: median {np.median(d[:, 34]):.0f} max {d[:, 34].max()}")
    slabs, tiles, loop = [], [], []
    for top, n_t in sorted(set(zip(d[:, 0], d[:, 35]))):
        rows = d[(d[:, 0] == top) & (d[:, 35] == n_t)]
        t = range(min(int(n_t), 8))
        wait = np.mean([rows[:, 3 + 4 * i] - rows[:, 2 + 4 * i] for i in t])
        main_ = np.mean([rows[:, 4 + 4 * i] - rows[:, 3 + 4 * i] for i in t])
        epi = np.mean([rows[:, 5 + 4 * i] - rows[:, 4 + 4 * i] for i in t])
        gap = np.mean([rows[:, 2 + 4 * i] - rows[:, 1 + 4 * i if i else 1] for i in t])
        print(f"  top {top} x {n_t} tiles ({len(rows)} CTAs): band loop {main_ / (top + 1):.0f} "
              f"a slab, epilogue {epi:.0f}, gap {gap:.0f}, wait {wait:.0f} a tile; "
              f"end {rows[:, 34].mean():.0f}")
        if n_t <= 8:
            slabs += [n_t * (top + 1)] * len(rows)
            tiles += [n_t] * len(rows)
            loop += list(rows[:, 3 + 4 * (n_t - 1) + 2] - rows[:, 1])
    (a, b), *_ = np.linalg.lstsq(np.stack([slabs, tiles], axis=1).astype(float),
                                 np.asarray(loop, dtype=float), rcond=None)
    print(f"tile loop = {a:.0f} cycles a slab + {b:.0f} a tile: a tile costs {b / a:.2f} slabs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
