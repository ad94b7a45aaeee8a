"""Compiled step loops: :func:`scan`, the port's counterpart of ``jax.jit`` +
``jax.lax.scan``.

``scan(body, carry, consts, length, key, chunk)`` runs ``carry = body(carry,
consts)`` ``length`` times and returns the last carry. ``carry`` and
``consts`` are flat tuples of tensors; the body returns a tuple of the
carry's shapes and dtypes. The operands' device picks the path:

- CPU tensors run :func:`scan_reference`, a Python loop;
- CUDA tensors replay ``torch.cuda.CUDAGraph``s of the body. If a capture or
  a replay fails, ``scan`` raises: nothing carries on in the Python loop,
  and nothing turns the graphs off;
- anything else raises.

On the card, the first call for a (``key``, carry and const shapes and
dtypes, device, ``chunk``) runs the body once on a side stream (the
warm-up: it fills ``utils.tensors.constant``'s cache, loads the kernels'
libraries and sets their attributes), then captures ``chunk`` steps into
one graph, and one step into a second graph when a call's ``length`` is not
a multiple of ``chunk``. A call copies carry and consts into the entry's
own buffers, replays the chunk graph ``length // chunk`` times and the
one-step graph ``length % chunk`` times, and returns clones: no buffer of
the cache escapes to a caller. ``chunk`` is a constant of each call site.

The body reads whatever changes between calls from ``carry`` and
``consts``: a tensor it closes over is baked into the graph by its address,
so a later call would read the old one. ``key`` names the body and holds a
reference to every object whose tensors the body closes over (the env), so
that none is freed while its graphs live; :func:`clear` drops every graph.
Each graph keeps a private memory pool.

A kernel wrapper's launch counter moves where the wrapper launches: in the
warm-up, and once for each step a capture records. A replay calls no
Python, so it moves no counter; what a replay ran on the card is read from
a trace of it (``chip_smoke.py`` counts K1 and K2 per replayed step under
``torch.profiler``).

Inside :func:`eager`, ``scan`` runs :func:`scan_reference` on CUDA tensors
too: the eager counterpart of a graph run on the same tensors, for
comparisons against the graphs and for wrappers that time or record a step
(which a replay would not call).

Gradients, the counterpart of ``jax.grad`` through ``lax.scan(
jax.checkpoint(body))``: on the CPU (and inside :func:`eager`) autograd
records the Python loop. On the card, when grad is enabled and a floating
operand requires grad, ``scan`` is an autograd function (``_GradScan``):

- its forward replays the one-step graph ``length`` times under no grad and
  keeps each step's input carry (O(length) carries);
- its backward replays a one-step VJP graph ``length`` times in reverse.
  That graph, captured once per signature, reads static buffers of
  (carry_t, consts, carry_bar_{t+1}), recomputes the step and runs
  ``torch.autograd.grad`` of ``body`` (a kernel's backward launches inside
  it, on the capture stream), writes carry_bar_t over carry_bar_{t+1} and
  adds consts_bar_t to a sum. The consts' gradient is that sum, the
  carry's the last carry_bar.

Gradients reach the carry's and the consts' floating tensors, never a
tensor the body closes over. Forward mode (``torch.func.jacfwd``) through
graphs raises: it waits for ROADMAP Queue 1 item 5.
"""

import contextlib
import ctypes
import functools
import time
from typing import Callable, Dict, NamedTuple, Sequence

import torch
from torch.autograd.function import once_differentiable

_eager = False


def scan_reference(body: Callable, carry: Sequence[torch.Tensor], consts: Sequence[torch.Tensor], length: int):
    """``length`` steps of ``carry = body(carry, consts)`` in a Python loop;
    returns the last carry (the inputs themselves when ``length`` is 0).
    Raises when a step returns a carry of other shapes or dtypes."""
    carry, consts = tuple(carry), tuple(consts)
    for _ in range(length):
        carry = _checked(body(carry, consts), carry)
    return carry


def scan(body: Callable, carry: Sequence[torch.Tensor], consts: Sequence[torch.Tensor], length: int, key, chunk: int = 1):
    """``length`` steps of ``carry = body(carry, consts)``: replayed CUDA
    graphs of ``chunk`` steps (and of one step for the remainder) on a CUDA
    device, :func:`scan_reference` on the CPU. ``key`` names the body (with
    the objects it closes over); it must be hashable."""
    carry, consts = tuple(carry), tuple(consts)
    if length < 0:
        raise ValueError(f"length must be >= 0, got {length}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    devices = {t.device for t in carry + consts}
    if len(devices) != 1:
        raise ValueError(f"scan operands lie on {len(devices)} devices: {devices}")
    device = devices.pop()
    if device.type == "cpu" or (device.type == "cuda" and _eager):
        return scan_reference(body, carry, consts, length)
    if device.type != "cuda":
        raise ValueError(f"no scan implementation for device {device}")
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in carry + consts):
        raise NotImplementedError(
            "scan on the card under a torch.func transform: forward mode through replayed graphs is not ported yet "
            "(ROADMAP Queue 1 item 5); differentiate with torch.autograd, or run inside graphs.eager()"
        )
    if length == 0:
        return carry
    if torch.is_grad_enabled() and any(t.requires_grad for t in carry + consts):
        return _GradScan.apply(body, key, length, len(carry), *carry, *consts)
    return _entry(body, carry, consts, key, device, chunk).run(body, carry, consts, length)


@contextlib.contextmanager
def eager():
    """Inside the block, :func:`scan` runs :func:`scan_reference`, the
    Python loop, on CUDA tensors too: the eager counterpart of a graph run,
    for comparisons and for stage timers and operand recorders."""
    global _eager
    saved, _eager = _eager, True
    try:
        yield
    finally:
        _eager = saved


def _entry(body, carry, consts, key, device, chunk) -> "_Entry":
    signature = (key, _shapes(carry), _shapes(consts), device, chunk)
    entry = _CACHE.get(signature)
    if entry is None:
        entry = _CACHE[signature] = _Entry(body, carry, consts, device, chunk)
    return entry


class _GradScan(torch.autograd.Function):
    """``scan`` on the card under autograd: the forward replays the one-step
    graph and keeps every step's input carry, the backward replays the
    one-step VJP graph in reverse."""

    @staticmethod
    def forward(ctx, body, key, length, n_carry, *tensors):
        carry, consts = tensors[:n_carry], tensors[n_carry:]
        device = carry[0].device if carry else consts[0].device
        entry = _entry(body, carry, consts, key, device, 1)
        inputs, out = entry.run_keeping(body, carry, consts, length)
        ctx.body, ctx.key, ctx.inputs, ctx.consts, ctx.device = body, key, inputs, consts, device
        ctx.mark_non_differentiable(*(t for t in out if not t.is_floating_point()))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *carry_bar):
        vjp = _vjp_entry(ctx.body, ctx.inputs[0], ctx.consts, ctx.key, ctx.device)
        carry_bar, consts_bar = vjp.run(ctx.inputs, ctx.consts, carry_bar)
        del ctx.inputs
        return (None, None, None, None, *carry_bar, *consts_bar)


def _vjp_entry(body, carry, consts, key, device) -> "_VJP":
    signature = (key, _shapes(carry), _shapes(consts), device)
    entry = _VJP_CACHE.get(signature)
    if entry is None:
        entry = _VJP_CACHE[signature] = _VJP(body, carry, consts, device)
    return entry


def replay_plan(length: int, chunk: int):
    """((chunk, replays), (1, replays)): how the card runs ``length`` steps
    with a graph of ``chunk`` steps and one of a single step."""
    return (chunk, length // chunk), (1, length % chunk)


class GraphStats(NamedTuple):
    """One cached graph: its scan's key, the batch (the carry's first
    dim), steps per replay, nodes, capture and instantiate seconds."""

    key: object
    batch: int
    steps: int
    nodes: int
    capture_s: float
    instantiate_s: float


def stats():
    """A :class:`GraphStats` for every cached step graph, in capture order
    (:func:`vjp_stats` lists the VJP graphs)."""
    out = []
    for (key, carry_shapes, _, _, _), entry in _CACHE.items():
        batch = carry_shapes[0][0][0] if carry_shapes and carry_shapes[0][0] else 0
        for graph in entry.graphs.values():
            out.append(GraphStats(key, batch, graph.steps, graph.nodes, graph.capture_s, graph.instantiate_s))
    return out


class VJPStats(NamedTuple):
    """One cached VJP graph: its scan's key, the batch, nodes, capture and
    instantiate seconds, and the bytes the card reserved for it (the
    growth of ``torch.cuda.memory_reserved`` over its warm-up and capture:
    its buffers and its memory pool)."""

    key: object
    batch: int
    nodes: int
    capture_s: float
    instantiate_s: float
    reserved_bytes: int


def vjp_stats():
    """A :class:`VJPStats` for every cached VJP graph, in capture order."""
    out = []
    for (key, carry_shapes, _, _), entry in _VJP_CACHE.items():
        batch = carry_shapes[0][0][0] if carry_shapes and carry_shapes[0][0] else 0
        g = entry.graph
        out.append(VJPStats(key, batch, g.nodes, g.capture_s, g.instantiate_s, entry.reserved_bytes))
    return out


def clear():
    """Drops every cached graph, its buffers and its memory pool."""
    _CACHE.clear()
    _VJP_CACHE.clear()


# -- the card's path -----------------------------------------------------------
class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    steps: int
    nodes: int
    capture_s: float
    instantiate_s: float


class _Entry:
    """The graphs of one body at one signature, over shared buffers: the
    carry, which each replay advances in place, and the consts."""

    def __init__(self, body, carry, consts, device, chunk):
        self.device, self.chunk = device, chunk
        self.carry = tuple(torch.empty(t.shape, dtype=t.dtype, device=device) for t in carry)
        self.consts = tuple(torch.empty(t.shape, dtype=t.dtype, device=device) for t in consts)
        self.graphs: Dict[int, _Graph] = {}
        self._load(carry, consts)
        with torch.no_grad():
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                _checked(body(self.carry, self.consts), self.carry)
            torch.cuda.current_stream(device).wait_stream(side)

    def run(self, body, carry, consts, length):
        with torch.cuda.device(self.device), torch.no_grad():
            plan = [(steps, replays) for steps, replays in replay_plan(length, self.chunk) if replays]
            for steps, _ in plan:
                if steps not in self.graphs:
                    self.graphs[steps] = self._capture(body, steps)
            self._load(carry, consts)
            for steps, replays in plan:
                for _ in range(replays):
                    self.graphs[steps].graph.replay()
            return tuple(t.clone() for t in self.carry)

    def run_keeping(self, body, carry, consts, length):
        """(each step's input carry, the last carry): ``length`` replays of
        the one-step graph (``chunk`` 1), the carry cloned before each."""
        with torch.cuda.device(self.device), torch.no_grad():
            if 1 not in self.graphs:
                self.graphs[1] = self._capture(body, 1)
            self._load(carry, consts)
            inputs = []
            for _ in range(length):
                inputs.append(tuple(t.clone() for t in self.carry))
                self.graphs[1].graph.replay()
            return inputs, tuple(t.clone() for t in self.carry)

    def _load(self, carry, consts):
        for static, t in zip(self.carry + self.consts, carry + consts):
            static.copy_(t)

    def _capture(self, body, steps) -> _Graph:
        """A graph of ``steps`` body steps from the carry buffers, ending
        with the last carry copied back into them. The carry buffers are
        left as they were: a capture runs nothing."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream = torch.cuda.Stream(self.device)
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.no_grad(), torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                out = self.carry
                for _ in range(steps):
                    out = _checked(body(out, self.consts), self.carry)
                for static, t in zip(self.carry, out):
                    static.copy_(t)
            finally:
                graph.capture_end()
        t1 = time.perf_counter()
        nodes = _node_count(graph)
        graph.instantiate()
        return _Graph(graph, steps, nodes, t1 - t0, time.perf_counter() - t1)


class _VJP:
    """The one-step VJP graph of one body at one signature. Static buffers:
    the step's input carry and the consts (read), carry_bar (read as the
    adjoint of the step's output carry, overwritten with the adjoint of its
    input carry) and consts_bar (the adjoint of the consts, summed over the
    replays since the last reset). Gradients flow to the floating tensors;
    the others' adjoints are None."""

    def __init__(self, body, carry, consts, device):
        self.device = device
        self.carry = tuple(torch.empty(t.shape, dtype=t.dtype, device=device) for t in carry)
        self.consts = tuple(torch.empty(t.shape, dtype=t.dtype, device=device) for t in consts)
        self.carry_bar = tuple(torch.zeros_like(t) if t.is_floating_point() else None for t in self.carry)
        self.consts_bar = tuple(torch.zeros_like(t) if t.is_floating_point() else None for t in self.consts)
        reserved = torch.cuda.memory_reserved(device)
        for static, t in zip(self.carry + self.consts, tuple(carry) + tuple(consts)):
            static.copy_(t)
        # a warm-up on a side stream (it fills the caches and loads the
        # kernels' libraries), then the capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._step(body)
        torch.cuda.current_stream(device).wait_stream(side)
        for t in self.consts_bar:
            if t is not None:
                t.zero_()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream = torch.cuda.Stream(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                self._step(body)
            finally:
                graph.capture_end()
        t1 = time.perf_counter()
        nodes = _node_count(graph)
        graph.instantiate()
        self.graph = _Graph(graph, 1, nodes, t1 - t0, time.perf_counter() - t1)
        self.reserved_bytes = torch.cuda.memory_reserved(device) - reserved

    def _step(self, body):
        """One step's VJP over the static buffers."""
        with torch.enable_grad():
            carry = tuple(t.detach().requires_grad_(t.is_floating_point()) for t in self.carry)
            consts = tuple(t.detach().requires_grad_(t.is_floating_point()) for t in self.consts)
            out = _checked(body(carry, consts), self.carry)
            pairs = [(o, g) for o, g in zip(out, self.carry_bar) if g is not None and o.requires_grad]
            leaves = [t for t in carry + consts if t.requires_grad]
            grads = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs], allow_unused=True)
        with torch.no_grad():
            # a carry's adjoint may be another's carry_bar itself (a body
            # that passes an entry through): copy those before any is overwritten
            bars = {b.data_ptr() for b in self.carry_bar if b is not None}
            grads = iter([g.clone() if g is not None and g.data_ptr() in bars else g for g in grads])
            for bar in self.carry_bar:
                if bar is not None:
                    g = next(grads)
                    bar.copy_(g) if g is not None else bar.zero_()
            for bar in self.consts_bar:
                if bar is not None:
                    g = next(grads)
                    if g is not None:
                        bar.add_(g)

    def run(self, inputs, consts, carry_bar):
        """(the adjoint of the first input carry, the consts' adjoint) from
        the adjoint ``carry_bar`` of the last output carry: one replay per
        step of ``inputs`` (each step's input carry), last step first."""
        with torch.cuda.device(self.device), torch.no_grad():
            for static, t in zip(self.consts, consts):
                static.copy_(t)
            for bar, g in zip(self.carry_bar, carry_bar):
                if bar is not None:
                    bar.copy_(g) if g is not None else bar.zero_()
            for bar in self.consts_bar:
                if bar is not None:
                    bar.zero_()
            for step in reversed(inputs):
                for static, t in zip(self.carry, step):
                    static.copy_(t)
                self.graph.graph.replay()
            return (
                tuple(None if g is None else g.clone() for g in self.carry_bar),
                tuple(None if g is None else g.clone() for g in self.consts_bar),
            )


_CACHE: Dict[tuple, _Entry] = {}
_VJP_CACHE: Dict[tuple, _VJP] = {}


def _shapes(tensors):
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _checked(out, carry):
    out = tuple(out)
    if _shapes(out) != _shapes(carry):
        raise ValueError(f"the body returned a carry of {_shapes(out)}, expected {_shapes(carry)}")
    return out


@functools.lru_cache(maxsize=None)
def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def _node_count(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a captured graph, from libcuda."""
    n = ctypes.c_size_t(0)
    rc = _libcuda().cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return n.value
