"""The `jascome` paper benchmark (reference: cli.py:36-115, 145-167).

The port of biem_helmholtz_sphere_tpu.cli._jascome.  For branching types
{a, ba, bpa, bba, bpbpa, caa} x n_end 1..9: two unit spheres at
(0, +-2, 0, ...), k = 1, plane wave along x0, sound-soft, triplet
translation method; writes jascome_output.csv and draws each coordinate
tree to {btype}.svg.  `clean_jascome` pivots per-dimension tables with
complex values formatted as +-a+-bi (reference cli.py:145-167).
"""

import csv
import logging
import os

import numpy as np
import torch

log = logging.getLogger(__name__)

BTYPES = ["a", "ba", "bpa", "bba", "bpbpa", "caa"]


def _center_pair(d):
    centers = np.zeros((2, d))
    centers[0, 1] = 2.0
    centers[1, 1] = -2.0
    return centers


def run_jascome(out_dir, n_end_max=9, btypes=None, device=None, dtype="float64"):
    """Write <out_dir>/jascome_output.csv; returns its path.  device: "cpu"
    or "cuda" (None: the card); dtype: "float64" or "float32"."""
    from ..biem import biem, plane_wave
    from ..coords import create_from_branching_types
    from ._accuracy import host_dev, provenance, resolve

    dev, rdt = resolve(device, dtype)
    os.makedirs(out_dir, exist_ok=True)
    btypes = btypes or BTYPES
    path = os.path.join(out_dir, "jascome_output.csv")
    with open(path, "w", newline="") as fh:
        wr = csv.writer(fh)
        # provenance columns mirror the reference (cli.py:57-59)
        wr.writerow(
            [
                "branching_types",
                "n_end",
                "uscat",
                "device",
                "dtype",
                "density_dtype",
                "density_device",
                "uscat_dtype",
                "uscat_device",
            ]
        )
        for btype in btypes:
            c = create_from_branching_types(btype)
            d = c.c_ndim
            # tree drawing (reference cli.py:70-73), next to the CSV
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            ax = c.draw()
            ax.figure.savefig(os.path.join(out_dir, f"{btype}.svg"))
            plt.close(ax.figure)
            direction = torch.zeros(d, dtype=rdt, device=dev)
            direction[0] = 1.0
            k = torch.tensor(1.0, dtype=rdt, device=dev)
            for n_end in range(1, n_end_max + 1):
                try:
                    uin, _ = plane_wave(k=k, direction=direction)
                    calc = biem(
                        c,
                        centers=torch.as_tensor(_center_pair(d), dtype=rdt, device=dev),
                        radii=torch.ones(2, dtype=rdt, device=dev),
                        k=k,
                        n_end=n_end,
                        uin=uin,
                        translational_coefficients_method="triplet",
                    )
                    u0c = calc.uscat(torch.zeros((d, 1), dtype=rdt, device=dev))
                    u0 = complex(u0c.reshape(-1)[0])
                    wr.writerow(
                        [
                            btype,
                            n_end,
                            f"({u0.real}{u0.imag:+}j)",
                            host_dev(dev),
                            dtype,
                            *provenance(calc.density, u0c),
                        ]
                    )
                    fh.flush()
                    log.debug("jascome %s n=%d: %s", btype, n_end - 1, u0)
                except Exception as e:  # the reference tolerates failures
                    log.warning("jascome %s n_end=%d failed: %s", btype, n_end, e)
    log.info("wrote %s", path)
    return path


def run_jascome_mfs(out_dir, n_src_max=800):
    """Independent-oracle convergence ladder for the jascome config.

    The reference's `jascome-bempp` (cli.py:118-142) solved the same
    two-unit-sphere k=1 configuration with bempp-cl at a mesh ladder
    h = 1/2 .. min_h and recorded uscat(0) converging to the spectral
    value.  bempp-cl is not a dependency; the built-in MFS oracle
    (validation/) is the equivalent *independent method* here: a
    source-count ladder n_src = 50 .. n_src_max, each row carrying the
    oracle's own boundary-residual certificate.  Writes
    jascome_mfs_output.csv (h column replaced by n_src + bc_residual).
    """
    from ..validation import mfs_uscat

    centers = _center_pair(3)
    path = os.path.join(out_dir, "jascome_mfs_output.csv")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["n_src", "bc_residual", "uscat"])
        n_src = 50
        while n_src <= n_src_max:
            r = mfs_uscat(
                centers=centers,
                radii=np.ones(2),
                k=1.0,
                direction=np.array([1.0, 0.0, 0.0]),
                n_src=n_src,
                src_depth=0.45,
            )
            u0 = complex(r.uscat(np.zeros((1, 3)))[0])
            w.writerow([n_src, f"{r.bc_residual:.3e}", u0])
            fh.flush()
            log.info("mfs n_src=%d bc_resid=%.2e uscat=%s", n_src, r.bc_residual, u0)
            n_src *= 2
    log.info("wrote %s", path)
    return path


def _fmt_complex(s):
    z = complex(str(s).replace(" ", ""))
    return f"{z.real:+.6f}{z.imag:+.6f}i"


def clean_jascome(out_dir):
    """Pivot per-dimension tables (reference cli.py:145-167)."""
    import pandas as pd

    from ..coords import create_from_branching_types

    src = os.path.join(out_dir, "jascome_output.csv")
    df = pd.read_csv(src)
    df["dim"] = [
        create_from_branching_types(bt).c_ndim for bt in df["branching_types"]
    ]
    df["n"] = df["n_end"] - 1  # cleaned tables index by max degree n
    out = []
    for dim, grp in df.groupby("dim"):
        piv = grp.pivot_table(
            index="n",
            columns="branching_types",
            values="uscat",
            aggfunc=lambda s: _fmt_complex(s.iloc[0]),
        )
        path = os.path.join(out_dir, f"jascome_output_{dim}d.csv")
        piv.to_csv(path)
        out.append(path)

    # clean the independent-oracle table too (reference cli.py:163-167
    # did the same for its bempp output)
    mfs_src = os.path.join(out_dir, "jascome_mfs_output.csv")
    if os.path.exists(mfs_src):
        dfm = pd.read_csv(mfs_src)
        dfm = dfm[["n_src", "uscat"]]
        dfm["uscat"] = dfm["uscat"].map(_fmt_complex)
        path = os.path.join(out_dir, "jascome_mfs_output_clean.csv")
        dfm.to_csv(path, index=False)
        out.append(path)
    return out
