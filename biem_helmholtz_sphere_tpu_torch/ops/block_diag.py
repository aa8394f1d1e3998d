"""KB: products with stacks of block-diagonal complex matrices.

The factored (S|R) matvec applies, per offset slot, the rotation D (degree
blocks of size 2l+1, 4.2% nonzero at n_end=32) and its adjoint, and per
radius the folded coaxial factor X (child-state m-blocks of size n-|m|
after an l<->m permutation, 2.1% nonzero).  The JAX package applies all
three as dense [H, H] einsums (biem_helmholtz_sphere_tpu/biem/_core.py,
the factored `mv`).  Here the matrices are packed to their diagonal
blocks; `block_diag_cmm` runs the CUDA kernel `csrc/block_diag_cmm.cu` on
CUDA tensors and the dense einsum (`_block_diag_cmm_plain`) on CPU
tensors.
"""

from dataclasses import dataclass, replace

import numpy as np
import torch

from . import kernels


@dataclass(frozen=True)
class BlockDiag:
    """A stack of block-diagonal [H, H] matrices, packed.

    Block b covers packed-layout rows/cols offs[b] .. offs[b]+sizes[b]; the
    packed layout maps to the basis layout through `perm` (None: identity).
    vals[..., voffs[b] + i*size + j] holds entry (i, j) of block b.
    """

    vals: torch.Tensor | None  # complex [..., nnz] (None: a layout only)
    offs: torch.Tensor  # int32 [nblk]
    sizes: torch.Tensor  # int32 [nblk]
    voffs: torch.Tensor  # int32 [nblk]
    rows: torch.Tensor  # int64 [nnz] basis row of each packed value
    cols: torch.Tensor  # int64 [nnz] basis column of each packed value
    perm: torch.Tensor | None  # int64 [H] packed index -> basis index
    inv_perm: torch.Tensor | None
    h: int
    g_max: int


def pack_layout(sizes, perm, h, device):
    """The packed layout of block-diagonal [h, h] matrices, without values
    (vals=None): block sizes in the packed layout, perm maps packed ->
    basis (None: identity)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes.sum() != h:
        raise ValueError(f"block sizes sum to {sizes.sum()}, not H={h}")
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    voffs = np.concatenate([[0], np.cumsum(sizes * sizes)[:-1]])
    p = np.arange(h) if perm is None else np.asarray(perm, dtype=np.int64)
    rows = np.concatenate([np.repeat(p[o : o + g], g) for o, g in zip(offs, sizes)])
    cols = np.concatenate([np.tile(p[o : o + g], g) for o, g in zip(offs, sizes)])

    def t(a, dt=torch.int32):
        return torch.as_tensor(a, dtype=dt, device=device)

    return BlockDiag(
        vals=None,
        offs=t(offs), sizes=t(sizes), voffs=t(voffs),
        rows=t(rows, torch.int64), cols=t(cols, torch.int64),
        perm=None if perm is None else t(p, torch.int64),
        inv_perm=None if perm is None else t(np.argsort(p), torch.int64),
        h=h, g_max=int(sizes.max()),
    )


def pack(dense, sizes, perm=None):
    """Pack dense [..., H, H] matrices that vanish off the given diagonal
    blocks (block sizes in the packed layout; perm maps packed -> basis)."""
    lay = pack_layout(sizes, perm, int(dense.shape[-1]), dense.device)
    return replace(lay, vals=dense[..., lay.rows, lay.cols].contiguous())


def unpack(a):
    """The dense [..., H, H] matrices of a BlockDiag (zeros off the blocks)."""
    dense = a.vals.new_zeros(a.vals.shape[:-1] + (a.h, a.h))
    dense[..., a.rows, a.cols] = a.vals
    return dense


def _block_diag_cmm_plain(dense, x, adjoint):
    """y[..., s, p, :] = op(A_s) x[..., s, p, :] with dense A [..., S, H, H]."""
    if adjoint:
        return x @ dense.conj()  # y_h = sum_g conj(A[g, h]) x_g
    return x @ dense.transpose(-1, -2)  # y_h = sum_g A[h, g] x_g


def block_diag_cmm(a, x, adjoint=False):
    """op(A_s) applied to every lane of x: x, y complex [..., S, P, H].

    A's stack shape a.vals.shape[:-1] must be a suffix of x.shape[:-2]
    (leading x axes share the matrices, e.g. D shared by the k's of a
    block).  op is the identity or, with adjoint=True, the conjugate
    transpose.
    """
    stack = a.vals.shape[:-1]
    if tuple(x.shape[-2 - len(stack):-2]) != tuple(stack) or x.shape[-1] != a.h:
        raise ValueError(
            f"x {tuple(x.shape)} does not match the matrix stack {tuple(stack)} "
            f"of [{a.h}, {a.h}] matrices"
        )
    if x.device.type == "cpu":
        return _block_diag_cmm_plain(unpack(a), x, adjoint)
    if x.device.type != "cuda":
        raise RuntimeError(f"block_diag_cmm: unsupported device {x.device}")
    if x.dtype not in (torch.complex64, torch.complex128) or a.vals.dtype != x.dtype:
        raise TypeError(f"block_diag_cmm: dtypes {a.vals.dtype}, {x.dtype}")
    if a.perm is not None:
        x = x.index_select(-1, a.perm)
    x = x.contiguous()
    y = torch.empty_like(x)
    n_mat = int(np.prod(stack))
    n_stack = x.numel() // (x.shape[-2] * x.shape[-1])
    kernels.launch(
        "bhs_block_diag_cmm",
        kernels.ptr(a.vals), kernels.ptr(a.offs), kernels.ptr(a.sizes),
        kernels.ptr(a.voffs), kernels.ptr(x), kernels.ptr(y),
        n_stack, n_mat, a.vals.shape[-1], x.shape[-2], a.h, len(a.sizes),
        a.g_max, int(adjoint), int(x.dtype == torch.complex128),
    )
    block_diag_cmm.launches += 1
    if a.perm is not None:
        y = y.index_select(-1, a.inv_perm)
    return y


block_diag_cmm.launches = 0
