"""KF's error per band as the number of bands grows, on the card.

    python tools/torch_kf_accuracy.py

For NB = 15, 16, 17, 27, 33, 49, 67 bands and both dtypes, on the card
tests' inputs (`tests/test_torch_cuda.py::_kf_inputs`: 'caa', offsets 2 .. 4
of 6, h's mantissas with their band exponents), prints the largest error
per band N relative to the band's largest |F| (and the band it is in) of
KF against its plain version, of KF against the plain version in float64
on the same inputs, and of the plain version against float64.
"""

import os
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def per_band(torch, got, ref):
    """(largest error relative to each band's largest |ref|, its band)."""
    err = ((got - ref).abs() / ref.abs().amax(dim=2, keepdim=True)).amax(dim=(0, 2))
    return float(err.max()), int(err.argmax())


def main():
    import torch

    from biem_helmholtz_sphere_tpu_torch.ops.band_sr import _band_f_plain, band_f
    from test_torch_cuda import _kf_inputs

    if not torch.cuda.is_available():
        print("torch_kf_accuracy: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for n_b in (15, 16, 17, 27, 33, 49, 67):
        for cdt in (torch.complex64, torch.complex128):
            coef, t_hat, tab = _kf_inputs(n_b, cdt, dev)
            got = band_f(coef, t_hat, tab, 2, 5)
            plain = _band_f_plain(coef, t_hat, tab, 2, 5)
            tab64 = SimpleNamespace(w=tab.w.double(), s_cart=tab.s_cart.double(), q_pad=tab.q_pad)
            f64 = _band_f_plain(coef.to(torch.complex128), t_hat.double(), tab64, 2, 5)
            print(f"NB={n_b} {cdt}: KF against the plain version {per_band(torch, got, plain)}, "
                  f"against float64 {per_band(torch, got.to(f64.dtype), f64)}; the plain "
                  f"version against float64 {per_band(torch, plain.to(f64.dtype), f64)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
