"""The floating-point operations a PyTorch function needs on given inputs:
the work term of a kernel's bound, counted on the plain version that
computes the same function.

:func:`needed_flops` runs the function under a dispatch mode that sees
every aten operation and counts, element by element, the arithmetic whose
operands are all nonzero. A product or a sum with an operand that is
exactly zero has a known result and needs no operation, so the count
follows the data: rows that a mask zeroed, forces that are zero off a
path, the zero entries of a model's subspaces, joint frames and
skew-symmetric factors cost nothing. A multiply or an add is one operation
(a fused multiply-add two), as is a divide, a square root, a sine or a
cosine; negations, comparisons, selections and data movement are none. A
matrix product counts, for each output entry, its nonzero products and the
sums between them. What the count does not remove: products by exactly
one, and the second half of a symmetric result, which a product computes
in full. An aten operation that the tables below do not name raises, so
that nothing is left uncounted.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# out = a op b, counted where both are nonzero (a zero operand gives the
# other, or zero)
_BINARY = {aten.add, aten.sub, aten.rsub, aten.mul}
# out = a / b, counted where a is nonzero
_DIVIDE = {aten.div}
# out = f(a), counted where a is nonzero (f(0) is known)
_UNARY = {aten.reciprocal, aten.sqrt, aten.sin, aten.cos}
_MATMUL = {aten.mm, aten.bmm}
_SUM = {aten.sum}
_CROSS = {aten.linalg_cross}
_NORM = {aten.linalg_vector_norm}
# no arithmetic: data movement, creation, comparisons, selections, negation
_FREE = {
    aten.view, aten._unsafe_view, aten.expand, aten.permute, aten.transpose, aten.t,
    aten.squeeze, aten.unsqueeze, aten.select, aten.slice, aten.alias, aten.clone, aten.copy_,
    aten._to_copy, aten.cat, aten.stack, aten.unbind, aten.index, aten.index_copy,
    aten.zeros_like, aten.new_zeros, aten.ones_like, aten.full_like, aten.eye,
    aten.neg, aten.clamp, aten.clamp_min, aten.maximum, aten.minimum, aten.where, aten.lt, aten.gt,
}


def _nonzero(x):
    return x != 0


def _nonzero_pairs(a, b):
    """The elements of the broadcast of a and b where both are nonzero;
    either may be a Python number."""
    if any(not isinstance(t, torch.Tensor) and t == 0 for t in (a, b)):
        return 0
    masks = [t != 0 for t in (a, b) if isinstance(t, torch.Tensor)]
    return (masks[0] & masks[1] if len(masks) == 2 else masks[0]).sum()


def _floating(x):
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _cross_ops(a, b, dim):
    """a x b: each component a_i b_j - a_j b_i costs its nonzero products
    and, where there are two, their difference."""
    na, nb = (_nonzero(t).movedim(dim, -1) for t in (a, b))
    ops = 0
    for i, j in ((1, 2), (2, 0), (0, 1)):
        t1, t2 = na[..., i] & nb[..., j], na[..., j] & nb[..., i]
        ops = ops + (t1.long() + t2.long() + (t1 & t2).long()).sum()
    return ops


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def _add(self, count):
        self.total = self.total + (count.to(torch.int64) if isinstance(count, torch.Tensor) else count)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        floating = any(_floating(a) for a in args)
        if packet in _FREE or not floating:
            pass
        elif packet in _BINARY:
            self._add(_nonzero_pairs(args[0], args[1]))
        elif packet in _DIVIDE:
            self._add(_nonzero_pairs(args[0], torch.ones_like(args[1]) if isinstance(args[1], torch.Tensor) else 1.0))
        elif packet in _UNARY:
            self._add(_nonzero(args[0]).sum())
        elif packet in _MATMUL:
            a, b = args[0], args[1]
            pairs = func(_nonzero(a).double(), _nonzero(b).double())
            self._add((2 * pairs - (pairs > 0).double()).sum())
        elif packet in _SUM:
            dims = args[1] if len(args) > 1 else None
            keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
            nnz = _nonzero(args[0]).sum(dims, keepdim=keepdim) if dims is not None else _nonzero(args[0]).sum()
            self._add((nnz - 1).clamp_min(0).sum())
        elif packet in _CROSS:
            self._add(_cross_ops(*args[:2], args[2] if len(args) > 2 else kwargs.get("dim", -1)))
        elif packet in _NORM and (args[1] if len(args) > 1 else kwargs.get("ord", 2)) == 2:
            # the nonzero squares, the sums between them and a square root
            dims = args[2] if len(args) > 2 else kwargs.get("dim")
            nnz = _nonzero(args[0]).sum(dims) if dims is not None else _nonzero(args[0]).sum()
            self._add((2 * nnz).sum())
        else:
            raise NotImplementedError(f"op_count has no rule for {func}")
        return func(*args, **kwargs)


def needed_flops(fn, *args, **kwargs) -> int:
    """The operations ``fn(*args, **kwargs)`` needs on these inputs, by the
    rules of this module; ``fn`` runs once, on the inputs' device."""
    counter = _Counter()
    with counter:
        fn(*args, **kwargs)
    return int(counter.total)
