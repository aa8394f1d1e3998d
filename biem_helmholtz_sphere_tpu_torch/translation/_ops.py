"""Constants of the d-dimensional plane-wave expansion.

e^{i k x.s^} = A_d sum_h i^{n_h} j_{n_h}(k|x|) Y_h(x^) conj(Y_h(s^)),
A_d = 2^{(d+1)/2} pi^{(d-1)/2}.  The translation operators themselves
(translation_matrix, the band scan, Graf) are not ported yet (ROADMAP
queue 1 item 9); the factored route needs only these constants and i**n.
"""

import numpy as np
import torch
from scipy.special import gamma


def _a_const(d):
    return 2.0 ** ((d + 1) / 2.0) * np.pi ** ((d - 1) / 2.0)


def _surface_area(d):
    return float(2.0 * np.pi ** (d / 2.0) / gamma(d / 2.0))


def ipow(n, dtype, device):
    """i**n, exactly, for an integer tensor or array n: complex tensor."""
    m = torch.as_tensor(n, device=device) % 4
    re = (m == 0).to(torch.int8) - (m == 2).to(torch.int8)
    im = (m == 1).to(torch.int8) - (m == 3).to(torch.int8)
    return torch.complex(re.double(), im.double()).to(dtype)
