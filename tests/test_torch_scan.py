"""``tds_tpu_torch.utils.graphs.scan`` on CPU tensors, its plain path
(``scan_reference``, a Python loop), in pure torch: no JAX. The card's path
(replayed CUDA graphs) is held to this one in tests/test_torch_scan_cuda.py.

- composing scans over a length cut into chunks and a remainder, as the
  card runs them (``replay_plan``), gives the whole scan's carry exactly;
- inside ``graphs.eager()`` a scan runs the Python loop, and the block
  restores the graph path on leaving, also when it raises;
- consts that change between calls under one key reach the body;
- the carry keeps its dtypes and shapes, ``length`` 0 returns the inputs,
  and a body that changes a carry's shape or dtype is refused;
- operands on a device with no path are refused, and the plain path carries
  gradients;
- ``refuse_grad``, the guard of the kernels K1 and K2, raises only when grad
  is enabled and an operand requires grad.
"""

import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.utils import graphs  # noqa: E402
from tds_tpu_torch.utils.tensors import refuse_grad  # noqa: E402


def _body(carry, consts):
    """A damped oscillator with an int32 step counter and a float32 sum."""
    x, v, t, s = carry
    k, c = consts
    a = -k * x - c * v
    v = v + 0.01 * a
    x = x + 0.01 * v
    return x, v, t + 1, s + x.float()


def _carry(seed, batch=5):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, 3, generator=gen, dtype=torch.float64)
    v = torch.randn(batch, 3, generator=gen, dtype=torch.float64)
    return x, v, torch.zeros(batch, dtype=torch.int32), torch.zeros(batch, 3, dtype=torch.float32)


def _consts(k, c):
    return torch.tensor(k, dtype=torch.float64), torch.tensor(c, dtype=torch.float64)


def _loop(carry, consts, length):
    for _ in range(length):
        carry = _body(carry, consts)
    return carry


@pytest.mark.parametrize("length,chunk", [(23, 5), (23, 23), (23, 1), (4, 7)])
def test_chunks_and_a_remainder_compose_to_the_whole_scan(length, chunk):
    (c_steps, c_replays), (one, r_replays) = graphs.replay_plan(length, chunk)
    assert (c_steps, one) == (chunk, 1) and c_steps * c_replays + r_replays == length
    assert r_replays < chunk or chunk == 1
    carry, consts = _carry(0), _consts(3.0, 0.2)
    pieces = carry
    for steps, replays in ((c_steps, c_replays), (one, r_replays)):
        for _ in range(replays):
            pieces = graphs.scan(_body, pieces, consts, steps, key="oscillator", chunk=steps)
    whole = graphs.scan(_body, carry, consts, length, key="oscillator", chunk=chunk)
    for p, w, e in zip(pieces, whole, _loop(carry, consts, length)):
        assert torch.equal(p, w) and torch.equal(w, e)


def test_consts_that_change_between_calls_reach_the_body():
    carry = _carry(1)
    first = graphs.scan(_body, carry, _consts(3.0, 0.2), 40, key="oscillator")
    second = graphs.scan(_body, carry, _consts(5.0, 0.0), 40, key="oscillator")
    for a, b, ea, eb in zip(first, second, _loop(carry, _consts(3.0, 0.2), 40), _loop(carry, _consts(5.0, 0.0), 40)):
        assert torch.equal(a, ea) and torch.equal(b, eb)
    assert not torch.equal(first[0], second[0])


def test_the_carry_keeps_its_dtypes_and_shapes():
    carry = _carry(2, batch=7)
    out = graphs.scan(_body, carry, _consts(1.0, 0.1), 9, key="oscillator")
    assert [(o.shape, o.dtype) for o in out] == [(c.shape, c.dtype) for c in carry]
    assert out[2].tolist() == [9] * 7


def test_length_zero_returns_the_inputs():
    carry = _carry(3)
    out = graphs.scan(_body, carry, _consts(1.0, 0.1), 0, key="oscillator")
    assert all(o is c for o, c in zip(out, carry))
    with pytest.raises(ValueError, match="length"):
        graphs.scan(_body, carry, _consts(1.0, 0.1), -1, key="oscillator")
    with pytest.raises(ValueError, match="chunk"):
        graphs.scan(_body, carry, _consts(1.0, 0.1), 3, key="oscillator", chunk=0)


def test_eager_runs_the_loop_inside_the_block_only(monkeypatch):
    calls = []
    monkeypatch.setattr(graphs, "scan_reference", lambda *args: calls.append(args[3]) or args[1])
    meta = tuple(t.to("meta") for t in _carry(7))
    with graphs.eager():
        graphs.scan(_body, _carry(7), _consts(1.0, 0.1), 4, key="oscillator")
    with pytest.raises(KeyError), graphs.eager():
        raise KeyError("leaves the block")
    with pytest.raises(ValueError, match="no scan implementation"):
        graphs.scan(_body, meta, tuple(t.to("meta") for t in _consts(1.0, 0.1)), 3, key="oscillator")
    assert calls == [4] and not graphs._eager


@pytest.mark.parametrize("change", ["shape", "dtype", "count"])
def test_a_carry_that_changes_is_refused(change):
    def body(carry, consts):
        x, v, t, s = _body(carry, consts)
        if change == "shape":
            return x[:-1], v, t, s
        if change == "dtype":
            return x, v, t.long(), s
        return x, v, t

    with pytest.raises(ValueError, match="carry"):
        graphs.scan(body, _carry(4), _consts(1.0, 0.1), 3, key=("changing", change))


def test_operands_on_a_device_without_a_path_are_refused():
    meta = tuple(t.to("meta") for t in _carry(5))
    with pytest.raises(ValueError, match="no scan implementation"):
        graphs.scan(_body, meta, tuple(t.to("meta") for t in _consts(1.0, 0.1)), 3, key="oscillator")


def test_the_plain_path_carries_gradients():
    x, v, t, s = _carry(6)
    k = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    out = graphs.scan(_body, (x, v, t, s), (k, torch.tensor(0.0, dtype=torch.float64)), 30, key="oscillator")
    out[0].sum().backward()
    eps = 1e-6
    plus = _loop((x, v, t, s), _consts(2.0 + eps, 0.0), 30)[0].sum()
    minus = _loop((x, v, t, s), _consts(2.0 - eps, 0.0), 30)[0].sum()
    torch.testing.assert_close(k.grad, (plus - minus) / (2 * eps), rtol=1e-6, atol=1e-9)


def test_refuse_grad_raises_only_where_a_gradient_would_be_dropped():
    a, b = torch.ones(3, requires_grad=True), torch.ones(3)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("PGS", (b, a))
    refuse_grad("PGS", (b, b))
    with torch.no_grad():
        refuse_grad("PGS", (a, b))
