"""Small utilities, as biem_helmholtz_sphere_tpu.utils._compat's.

* `btensorsolve`: reshape a [..., B, H, B', H'] block tensor and a
  [..., B, H] right-hand side to a square system and solve it
  (`torch.linalg.solve`), batched over the leading `num_batch_axes` axes.
* `shift_nth_row_n_steps`: roll row n of a matrix by n steps (cyclic),
  one gather.
"""

import numpy as np
import torch

from ..ops.kernels import as_tensors


def btensorsolve(matrix, rhs, num_batch_axes=0):
    """Batched tensorsolve: collapse the non-batch axes into a square system.

    matrix: [batch..., I1..Ik, J1..Jk] with prod(I) == prod(J);
    rhs: [batch..., I1..Ik].  Returns [batch..., J1..Jk], on the device of
    the tensors given, else on the card.
    """
    m, b = as_tensors(matrix, rhs)
    batch = tuple(m.shape[:num_batch_axes])
    rhs_shape = tuple(b.shape[num_batch_axes:])
    n = int(np.prod(rhs_shape, dtype=np.int64)) if rhs_shape else 1
    sol_shape = tuple(m.shape[num_batch_axes + len(rhs_shape):])
    dt = torch.promote_types(m.dtype, b.dtype)
    x = torch.linalg.solve(m.to(dt).reshape(batch + (n, n)), b.to(dt).reshape(batch + (n,)))
    return x.reshape(batch + sol_shape)


def shift_nth_row_n_steps(a, axis_row=-2, axis_shift=-1):
    """Shift row n by n steps along axis_shift (cyclic); on a's device when
    it is a tensor, else on the card."""
    (a,) = as_tensors(a)
    nd = a.ndim
    ar, ash = axis_row % nd, axis_shift % nd
    x = torch.movedim(a, (ar, ash), (-2, -1))
    nrows, ncols = x.shape[-2], x.shape[-1]
    rows = torch.arange(nrows, device=a.device)[:, None]
    cols = (torch.arange(ncols, device=a.device)[None, :] - rows) % ncols
    out = torch.gather(x, -1, cols.expand(x.shape))
    return torch.movedim(out, (-2, -1), (ar, ash))
