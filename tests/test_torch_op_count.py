"""The count of the operations a function needs (tds_tpu_torch.utils.op_count),
the work term of the kernels' bounds in chip_smoke.py: dense products count
in full, zero operands cost nothing, and an operation without a rule
raises. The file imports neither JAX nor the JAX package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.utils import op_count  # noqa: E402


def _dense(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0.5, 1.5, shape))


@pytest.mark.parametrize("batch", [None, 4])
def test_dense_matrix_product_counts_its_multiplies_and_adds(batch):
    a, b = _dense(3, 5), _dense(5, 2, seed=1)
    if batch:
        a, b = a.expand(batch, 3, 5), b.expand(batch, 5, 2)
    # each of the 6 outputs: 5 products and 4 sums
    assert op_count.needed_flops(torch.matmul, a, b) == (batch or 1) * 6 * 9
    assert op_count.needed_flops(torch.einsum, "...ij,...jk->...ik", a, b) == (batch or 1) * 6 * 9


def test_zero_operands_cost_nothing():
    a, b = _dense(4), _dense(4, seed=1)
    a[1] = 0.0
    assert op_count.needed_flops(torch.mul, a, b) == 3
    assert op_count.needed_flops(torch.add, a, b) == 3
    assert op_count.needed_flops(lambda x: x * 2.0, a) == 3
    assert op_count.needed_flops(lambda x: x * 0.0, a) == 0
    assert op_count.needed_flops(torch.div, a, b) == 3
    assert op_count.needed_flops(lambda x: x.sum(-1), a) == 2
    assert op_count.needed_flops(torch.sin, a) == 3
    # a skew-symmetric matrix has 6 nonzero entries: 2 products and a sum
    # for each output entry of its product with a dense vector
    p = _dense(3)
    px = torch.tensor([[0.0, -p[2], p[1]], [p[2], 0.0, -p[0]], [-p[1], p[0], 0.0]], dtype=p.dtype)
    assert op_count.needed_flops(torch.matmul, px, _dense(3, 1)) == 9


def test_cross_product_counts_the_nonzero_terms():
    a, b = _dense(3), _dense(3, seed=1)
    assert op_count.needed_flops(torch.linalg.cross, a, b) == 9
    axis = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype)
    assert op_count.needed_flops(torch.linalg.cross, axis, b) == 2


def test_moving_data_costs_nothing_and_unknown_operations_raise():
    a = _dense(3, 3)
    assert op_count.needed_flops(lambda x: torch.cat([x.t(), x[1:]]).reshape(-1).clone(), a) == 0
    with pytest.raises(NotImplementedError, match="no rule"):
        op_count.needed_flops(torch.linalg.inv, a)
