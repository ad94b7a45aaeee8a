"""Small dense linear algebra (counterpart of tds_tpu/algebra/linalg.py):
the closed-form 3x3 inverse and the Cholesky factorization behind
``minv_method="crba"`` and the spring contact's dense M^-1.

The factorization and the triangular solves loop over the static size n
in Python, one column (or row) of the batch at a time, so that they run
the same on the CPU, under autograd and ``torch.func``, and inside a CUDA
graph (no LAPACK call, no host synchronisation). ``pattern`` (from
:func:`symbolic_cholesky_fill`) zeroes the structurally-zero entries of
the factor, as the JAX package skips them.
"""

import numpy as np
import torch

from tds_tpu_torch.utils.tensors import constant


def inv3(m):
    """Closed-form inverse of (..., 3, 3) via the adjugate (not
    ``torch.linalg.inv``, so that float64 agrees with the JAX package to
    the last bits)."""
    (a, b, c), (d, e, f), (g, h, i) = (row.unbind(-1) for row in m.unbind(-2))
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [
            torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * (1.0 / det)[..., None, None]


def symbolic_cholesky_fill(mask):
    """Lower-triangular nonzero pattern (numpy bool) of chol(A) for a
    boolean coupling mask: nz(i, j) iff A(i, j) != 0 or some k < j has
    nz(i, k) and nz(j, k)."""
    mask = np.asarray(mask, bool)
    n = mask.shape[0]
    nz = np.tril(mask | np.eye(n, dtype=bool))
    for j in range(n):
        for i in range(j + 1, n):
            if not nz[i, j]:
                for k in range(j):
                    if nz[i, k] and nz[j, k]:
                        nz[i, j] = True
                        break
    return nz


def _pattern_mask(pattern, like: torch.Tensor):
    """The pattern as a cached bool tensor on ``like``'s device (no copy
    from the host inside a step)."""
    if pattern is None:
        return None
    return constant(tuple(map(tuple, np.asarray(pattern, bool).tolist())), torch.bool, like.device)


def cholesky_unrolled(a, pattern=None):
    """Lower Cholesky factor of SPD (..., n, n), a column at a time; with
    ``pattern`` the entries outside it are exactly zero."""
    n = a.shape[-1]
    mask = _pattern_mask(pattern, a)
    cols = []  # (..., n) columns of L, zero above the diagonal
    for j in range(n):
        s = a[..., :, j]
        if j:
            done = torch.stack(cols, dim=-1)  # (..., n, j)
            s = s - (done * done[..., j : j + 1, :]).sum(-1)
        ljj = s[..., j].sqrt()
        col = torch.cat([torch.zeros_like(s[..., :j]), ljj[..., None], s[..., j + 1 :] * (1.0 / ljj)[..., None]], dim=-1)
        if mask is not None:
            col = torch.where(mask[:, j], col, torch.zeros_like(col))
        cols.append(col)
    return torch.stack(cols, dim=-1)


def cho_solve_unrolled(l, b, pattern=None):
    """Solve A x = b given the lower Cholesky factor ``l`` of A; ``b`` is
    (..., n) or (..., n, k). ``pattern`` is accepted for the JAX
    signature: the factor's structural zeros are exact zeros already."""
    n = l.shape[-1]
    vec = b.dim() == l.dim() - 1
    if vec:
        b = b[..., None]
    y = []
    for i in range(n):
        s = b[..., i, :]
        if i:
            s = s - (l[..., i, :i, None] * torch.stack(y, dim=-2)).sum(-2)
        y.append(s / l[..., i, i, None])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        if i < n - 1:
            s = s - (l[..., i + 1 :, i, None] * torch.stack(x[i + 1 :], dim=-2)).sum(-2)
        x[i] = s / l[..., i, i, None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def solve_pd(a, b):
    """Solve an SPD system through :func:`cholesky_unrolled`."""
    return cho_solve_unrolled(cholesky_unrolled(a), b)


def inv_pd(a):
    """Inverse of SPD (..., n, n) through :func:`cholesky_unrolled`."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(a.shape)
    return cho_solve_unrolled(cholesky_unrolled(a), eye)
