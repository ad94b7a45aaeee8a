"""Small dense linear algebra (counterpart of tds_tpu/algebra/linalg.py:
the closed-form 3x3 inverse; the unrolled Cholesky behind
``minv_method="crba"`` is not ported)."""

import torch


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
