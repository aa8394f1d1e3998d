"""Accuracy of the port's cylinder seeds near the series/asymptotics seam.

    python tools/torch_cyl_seam.py

Prints the largest absolute error against scipy.special of J0, J1,
H^{(1)}_0 and H^{(1)}_1 at real z in [10, 14] (the ascending series' side
of the seam |z| = 14, where its terms reach ~1e5 before they cancel) for:

- the series evaluated in float32 arithmetic (`special/_cyl.py`'s Horner
  steps on complex64 inputs: what a float32 kernel would compute);
- `cyl_jh01` on float32 inputs (evaluated in float64, rounded to
  complex64: what the port and K5's base-2 mode compute);
- `cyl_jh01` in float64;

and, for the first and the second, the largest error of the normalised
scaled h mantissas of d = 2 at z = 13.9 + 1j against float64.  CPU only;
these are accuracy numbers, not times.
"""

import os
import sys

import numpy as np
import scipy.special as sp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from biem_helmholtz_sphere_tpu_torch.special import _cyl, _family

    z = np.linspace(10.0, 14.0, 401)
    ref = (sp.jv(0, z), sp.jv(1, z), sp.hankel1(0, z), sp.hankel1(1, z))
    z32 = torch.tensor(z, dtype=torch.complex64)
    j0, j1 = _cyl._series_j01(z32)
    y0, y1 = _cyl._series_y01(z32, j0, j1)
    series32 = (j0, j1, j0 + 1j * y0, j1 + 1j * y1)
    rows = {
        "series in float32 arithmetic": series32,
        "cyl_jh01, float32 in (float64 inside)": _cyl.cyl_jh01(z32),
        "cyl_jh01, float64": _cyl.cyl_jh01(torch.tensor(z)),
    }
    names = ("J0", "J1", "H0", "H1")
    print("max |error| against scipy.special at real z in [10, 14]:")
    for label, vals in rows.items():
        errs = [float(np.abs(v.numpy().astype(np.complex128) - r).max())
                for v, r in zip(vals, ref)]
        print(f"  {label:40s} " + "  ".join(f"{n} {e:.3e}" for n, e in zip(names, errs)))

    # the scaled h of d = 2 at z = 13.9 + 1j: float32 seeds from the float32
    # series against the float64 family
    zc = np.array([13.9 + 1.0j])
    hm64, he64 = _family._spherical_h_scaled_plain(2, 8, torch.tensor(zc))
    for label, seeds in (("series in float32 arithmetic", "f32"),
                         ("cyl_jh01, float32 in (float64 inside)", "f64")):
        saved = _cyl.cyl_jh01
        if seeds == "f32":
            def f32_seeds(zz):
                a0, a1 = _cyl._series_j01(zz)
                b0, b1 = _cyl._series_y01(zz, a0, a1)
                return a0, a1, a0 + 1j * b0, a1 + 1j * b1
            _family.cyl_jh01 = f32_seeds
        try:
            hm, he = _family._spherical_h_scaled_plain(2, 8, torch.tensor(zc, dtype=torch.complex64))
        finally:
            _family.cyl_jh01 = saved
        d = (hm.to(torch.complex128) * torch.exp(he.double() - he64) - hm64).abs().max()
        print(f"scaled h mantissas (d = 2, n < 8) at z = 13.9 + 1j, {label}: max |error| "
              f"{float(d):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
