"""Convergence sweeps and error heatmaps (reference: cli.py:188-333).

The port of biem_helmholtz_sphere_tpu.cli._accuracy: the same two sweep
modes, CSV columns and file names, on the port's `biem()`.
  mode="k":       2 unit spheres at (0, +-2, 0, ...), k in 2^{0..K step 0.5}
  mode="n_balls": 2D lattice of (2 2^m)^2 spheres (reference cli._center),
                  k = 1, through `biem()`'s own route (no n_end schedule)

In mode="k" the incident plane wave is built at FIXED wavenumber
uin_k=1.0 while the solver's k is swept: the reference's accuracy
command hardcodes `plane_wave(k=xp.asarray(1.0), ...)` (reference
cli.py:238-243) and its committed accuracy_k_*.csv artifacts were
generated that way; reproducing the artifact requires matching the quirk.
n_end runs over unique(int(2^{0..N step 0.25})) (or 1..N with
n_end_linear); a CSV row is appended per k (incremental checkpointing),
NaN guards raise, and a block that fails (out of memory, overflow at
extreme parameters) is logged and skipped, so the sweep goes on
(reference cli.py:269-271).  A block of k_block k-points is one batched
`biem()` call; its rows share the block's wall time (device synchronized).
"""

import csv
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger(__name__)


def lattice_centers(n_side, d, spacing=4.0):
    """2D square lattice in the (x0, x1) plane (reference cli.py:170-185)."""
    g = (np.arange(n_side) - (n_side - 1) / 2) * spacing
    xx, yy = np.meshgrid(g, g)
    centers = np.zeros((n_side * n_side, d))
    centers[:, 0] = xx.ravel()
    centers[:, 1] = yy.ravel()
    return centers


def pair_centers(d):
    centers = np.zeros((2, d))
    centers[0, 1] = 2.0
    centers[1, 1] = -2.0
    return centers


def resolve(device=None, dtype="float64"):
    """(torch device, real dtype) of a CLI run: --device cpu or cuda (None:
    the card, raising without CUDA), --dtype float64 or float32."""
    from ..ops.kernels import default_device

    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dtype not in ("float64", "float32"):
        raise ValueError(f"dtype {dtype!r} is neither float64 nor float32")
    return dev, torch.float64 if dtype == "float64" else torch.float32


def host_dev(dev):
    """The CSV's device column: 'cpu' or 'cuda:<index>'."""
    return "cpu" if dev.type == "cpu" else f"cuda:{dev.index}"


def _dev_name(t):
    return host_dev(t.device)


def provenance(density, uscat):
    """(density_dtype, density_device, uscat_dtype, uscat_device) columns
    matching the reference sweep CSVs (reference cli.py:57-59,208-211)."""
    return (str(density.dtype).removeprefix("torch."), _dev_name(density),
            str(uscat.dtype).removeprefix("torch."), _dev_name(uscat))


_HEADER = [
    "branching_types",
    "mode",
    "n_balls",
    "k",
    "n_end",
    "uscat_real",
    "uscat_imag",
    "seconds",
    "device",
    "dtype",
    "density_dtype",
    "density_device",
    "uscat_dtype",
    "uscat_device",
    # iterative-solver diagnostics per system: relres and Krylov steps;
    # direct (LU) rows, exact to rounding, carry "exact"
    "solve_relres",
    "solve_iters",
]


def _open_sweep_csv(path):
    """Open the sweep CSV for append, migrating any pre-provenance file
    out of the way (rows must align with the current header).  A file
    whose header is a strict PREFIX of the current one (columns were
    appended since) is upgraded in place: old rows get empty cells for
    the new columns, so committed artifact rows survive schema growth."""
    if os.path.exists(path):
        with open(path, newline="") as fh:
            first = fh.readline().strip()
        if first != ",".join(_HEADER) and first.split(",") == _HEADER[
            : len(first.split(","))
        ]:
            pad = len(_HEADER) - len(first.split(","))
            with open(path, newline="") as fh:
                rows = list(csv.reader(fh))
            with open(path, "w", newline="") as fh:
                w = csv.writer(fh)
                w.writerow(_HEADER)
                for r in rows[1:]:
                    w.writerow(r + [""] * pad)
            log.info("upgraded %s schema in place (+%d columns)", path, pad)
            first = ",".join(_HEADER)
        if first != ",".join(_HEADER):
            base, ext = os.path.splitext(path)
            n = 0
            while os.path.exists(f"{base}_legacy{n}{ext}"):
                n += 1
            os.rename(path, f"{base}_legacy{n}{ext}")
            log.info("migrated old-schema %s to %s_legacy%d%s", path, base, n, ext)
    new = not os.path.exists(path)
    fh = open(path, "a", newline="")
    wr = csv.writer(fh)
    if new:
        wr.writerow(_HEADER)
    return fh, wr


def _n_end_grid(n_end_max_log2, n_end_min_log2=0.0):
    vals = sorted(
        {
            int(2.0**e)
            for e in np.arange(
                max(n_end_min_log2, 0.0), n_end_max_log2 + 1e-9, 0.25
            )
        }
    )
    return [v for v in vals if v >= 1]


def solve_block(c, centers, n_end, ks, dev, rdt, uin_k=None):
    """One batched `biem()` call over ks (a 0-d k for one point): (density,
    uscat at the origin [1, ...], relres, iters).  uin_k: the incident
    wave's own k (mode="k": 1.0, the reference's quirk), else k itself."""
    from ..biem import biem, plane_wave

    d = c.c_ndim
    k = torch.as_tensor(np.asarray(ks, np.float64), dtype=rdt, device=dev)
    if len(ks) == 1:
        k = k[0]
    nb = len(centers)
    direction = torch.zeros(d, dtype=rdt, device=dev)
    direction[0] = 1.0
    uin, _ = plane_wave(
        k=k if uin_k is None else torch.full_like(k, uin_k),
        direction=direction.reshape((d,) + (1,) * k.ndim).expand((d,) + k.shape),
    )
    centers_t = torch.as_tensor(centers, dtype=rdt, device=dev)
    calc = biem(
        c,
        centers=centers_t.expand(k.shape + (nb, d)),
        radii=torch.ones(nb, dtype=rdt, device=dev).expand(k.shape + (nb,)),
        k=k,
        n_end=n_end,
        uin=uin,
    )
    u0 = calc.uscat(torch.zeros((d, 1), dtype=rdt, device=dev))
    return calc.density, u0, calc.relres, calc.iters


def run_accuracy(
    out_dir,
    branching_types=("a", "ba"),
    mode="k",
    k_max_log2=6.0,
    n_end_max_log2=7.0,
    n_balls_max_log4=3,
    k_block=1,
    k_min_log2=0.0,
    n_end_min_log2=0.0,
    n_balls_min_log4=0,
    n_end_linear=0,
    device=None,
    dtype="float64",
):
    """Append the sweep's rows to <out_dir>/accuracy.csv; returns its path.
    device: "cpu" or "cuda" (None: the card); dtype: "float64" (complex128)
    or "float32" (complex64)."""
    from ..coords import create_from_branching_types

    dev, rdt = resolve(device, dtype)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "accuracy.csv")
    fh, wr = _open_sweep_csv(path)
    with fh:

        def run_block(btype, mode_, c, centers, ks, n_balls, n_end, uin_k=None):
            """Solve a block of k values in ONE batched call and write one
            CSV row per k; per-row wall time is the block time / block
            size."""
            t0 = time.perf_counter()
            try:
                dens_c, u0c, rr_c, it_c = solve_block(c, centers, n_end, ks, dev, rdt, uin_k)
                prov = provenance(dens_c, u0c)
                rr = None if rr_c is None else np.broadcast_to(
                    rr_c.cpu().numpy(), (len(ks),))
                it_n = None if it_c is None else np.broadcast_to(
                    it_c.cpu().numpy(), (len(ks),))
                dens = dens_c.cpu().numpy().reshape(len(ks), -1)
                u0s = u0c.cpu().numpy().reshape(len(ks), -1)[:, 0]
                per_k = round((time.perf_counter() - t0) / len(ks), 4)
            except Exception as e:  # the sweep goes on past a failed block
                for k in ks:
                    log.warning("accuracy %s B=%d k=%g n_end=%d failed: %s",
                                btype, n_balls, k, n_end, e)
                return
            for i, k in enumerate(ks):
                try:
                    if np.any(np.isnan(dens[i])):
                        raise ValueError("density contains NaN")
                    u0 = complex(u0s[i])
                    if np.isnan(u0.real) or np.isnan(u0.imag):
                        raise ValueError("uscat contains NaN")
                    wr.writerow(
                        [
                            btype,
                            mode_,
                            n_balls,
                            k,
                            n_end,
                            u0.real,
                            u0.imag,
                            per_k,
                            host_dev(dev),
                            dtype,
                            *prov,
                            "exact" if rr is None else f"{float(rr[i]):.3e}",
                            "exact" if it_n is None else int(it_n[i]),
                        ]
                    )
                    fh.flush()
                    log.debug(
                        "%s B=%d k=%g n_end=%d -> %s", btype, n_balls, k, n_end, u0
                    )
                except ValueError as e:
                    log.warning(
                        "accuracy %s B=%d k=%g n_end=%d failed: %s",
                        btype,
                        n_balls,
                        k,
                        n_end,
                        e,
                    )

        try:
            from tqdm import tqdm
        except ImportError:  # pragma: no cover
            tqdm = lambda it, **kw: it  # noqa: E731

        for btype in branching_types:
            c = create_from_branching_types(btype)
            d = c.c_ndim
            if mode == "k":
                centers = pair_centers(d)
                kvals = [
                    2.0**e
                    for e in np.arange(k_min_log2, k_max_log2 + 1e-9, 0.5)
                ]
                # the reference's ba artifact sweeps n_end densely
                # (accuracy_k_ba.csv: 1..39 step 1); its a artifact uses
                # the log2 grid (accuracy_k_a.csv)
                n_end_vals = (
                    list(range(1, n_end_linear + 1))
                    if n_end_linear
                    else _n_end_grid(n_end_max_log2, n_end_min_log2)
                )
                for n_end in tqdm(n_end_vals, desc=f"{btype} k-sweep"):
                    blk = max(1, int(k_block))
                    for i0 in range(0, len(kvals), blk):
                        run_block(btype, mode, c, centers, kvals[i0 : i0 + blk], 2, n_end,
                                  uin_k=1.0)
            else:
                lattices = [
                    lattice_centers(2 * 2**m, d)
                    for m in range(n_balls_min_log4, n_balls_max_log4 + 1)
                ]
                for centers in tqdm(lattices, desc=f"{btype} n_balls-sweep"):
                    for n_end in _n_end_grid(n_end_max_log2, n_end_min_log2):
                        run_block(btype, mode, c, centers, [1.0], len(centers), n_end)
    log.info("appended to %s", path)
    return path


def plot_accuracy(out_dir):
    """Error heatmaps: ground truth per sweep key = highest-n_end non-NaN
    row (reference cli.py:306-309); |uscat - truth| heatmap per branching
    type -> accuracy_heatmap_{mode}_{btype}.jpg."""
    import glob

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    from matplotlib.colors import LogNorm

    frames = [
        pd.read_csv(f) for f in glob.glob(os.path.join(out_dir, "accuracy*.csv"))
    ]
    if not frames:
        raise FileNotFoundError(f"no accuracy CSVs in {out_dir}")
    df = pd.concat(frames, ignore_index=True)
    df["uscat"] = df["uscat_real"] + 1j * df["uscat_imag"]
    # where the same sweep point exists at several precisions (the TPU
    # float32 bulk sweep overlaps the CPU float64 extreme-corner rows),
    # keep the highest-precision row
    if "dtype" in df.columns:
        rank = df["dtype"].map({"float64": 0, "float32": 1}).fillna(2)
        df = (
            df.assign(_rank=rank)
            # descending rank + stable sort puts the highest-precision
            # rows last in file/row order, so keep="last" selects the
            # LATEST highest-precision row deterministically — a re-run
            # sweep row supersedes older rows of the same precision
            # (ADVICE r2: default quicksort made the survivor arbitrary)
            .sort_values("_rank", ascending=False, kind="stable")
            .drop_duplicates(
                subset=["branching_types", "mode", "n_balls", "k", "n_end"],
                keep="last",
            )
            .drop(columns="_rank")
        )
    out = []
    for (btype, mode), grp in df.groupby(["branching_types", "mode"]):
        key = "k" if mode == "k" else "n_balls"
        rows = []
        for kv, sub in grp.groupby(key):
            sub = sub.dropna(subset=["uscat_real"])
            truth = sub.loc[sub["n_end"].idxmax(), "uscat"]
            for _, r in sub.iterrows():
                rows.append((kv, r["n_end"], abs(r["uscat"] - truth)))
        piv = (
            pd.DataFrame(rows, columns=[key, "n_end", "err"])
            .pivot_table(index="n_end", columns=key, values="err")
            .sort_index(ascending=False)
        )
        fig, ax = plt.subplots(figsize=(6, 4.5))
        vals = piv.values
        vmin = max(np.nanmin(vals[vals > 0]) if (vals > 0).any() else 1e-16, 1e-16)
        im = ax.imshow(
            np.maximum(vals, vmin / 10),
            aspect="auto",
            norm=LogNorm(vmin=vmin, vmax=max(np.nanmax(vals), vmin * 10)),
            cmap="viridis",
        )
        ax.set_xticks(range(len(piv.columns)))
        ax.set_xticklabels([f"{v:g}" for v in piv.columns], rotation=90, fontsize=6)
        ax.set_yticks(range(len(piv.index)))
        ax.set_yticklabels([f"{v:g}" for v in piv.index], fontsize=6)
        ax.set_xlabel(key)
        ax.set_ylabel("n_end")
        ax.set_title(f"|uscat - truth|  ({btype}, {mode}-sweep)")
        fig.colorbar(im, ax=ax)
        path = os.path.join(out_dir, f"accuracy_heatmap_{mode}_{btype}.jpg")
        fig.savefig(path, dpi=160, bbox_inches="tight")
        plt.close(fig)
        out.append(path)
        log.info("wrote %s", path)
    return out
