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
tensor the body closes over.

Under a ``torch.func`` transform (``jvp``, ``jacfwd``, ``vmap``,
``jacrev``, ``vjp``) ``scan`` on the card is ``_TransformScan``, an autograd function with a rule for
each transform, and each rule is a scan of a transformed body, replayed
as graphs like any other:

- its JVP scans ``torch.func.jvp`` of the body over (carry, carry
  tangent) with (consts, consts' tangents): a one-step JVP graph that
  carries primal and tangent together, captured on static buffers once
  per signature and replayed ``length`` times (a kernel's forward mode
  launches inside it: K1's JVP kernel through ``PGSFunction.jvp``);
- its vmap rule scans ``torch.func.vmap`` of the body over the batched
  operands (an unbatched carry entry expanded to the batch), the width T
  in the graph's key. ``jacfwd`` through ``scan`` is that rule over the
  JVP's scan: one graph of T tangents, in which K1's JVP runs on T B rows
  (the vmap rule of ``contact.pgs.PGSJVP``);
- its backward (``jacrev``, ``torch.func.vjp``) replays the one-step graph
  to recover each step's input carry and then the one-step VJP graph in
  reverse, as ``_GradScan`` does; under vmap (``jacrev``'s batch of
  cotangents) it runs once for each cotangent.

Inside these graphs the kernels run, never their plain versions. Forward
AD's dual tensors (``torch.autograd.forward_ad``) raise on the card: the
JVP rule's ``torch.func.jvp`` cannot nest inside a dual level.

A body may read a switch (:func:`switch`, :func:`switched`) as the JAX
package reads a flag at trace time: the switches in force when ``scan`` is
called are part of every graph's signature, so a graph captured under one
setting is never replayed under another
(``dynamics.forward_dynamics.reference_base_abi_quirk`` is one).
"""

import contextlib
import ctypes
import functools
import time
from typing import Callable, Dict, NamedTuple, Sequence

import torch
from torch.autograd.function import once_differentiable

_eager = False
_switches: Dict[str, object] = {}


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
    return _card_scan(body, carry, consts, length, key, chunk, device)


def _card_scan(body, carry, consts, length, key, chunk, device):
    """``scan`` on the card: the transforms' function, the gradient's, or
    the graphs' replay."""
    tensors = carry + consts
    if length == 0:
        return carry
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors):
        return _TransformScan.apply(body, key, length, chunk, len(carry), *tensors)
    if torch.autograd.forward_ad._current_level >= 0 and any(
            torch.autograd.forward_ad.unpack_dual(t).tangent is not None for t in tensors):
        # the JVP rule scans torch.func.jvp of the body, and forward AD does not nest
        raise NotImplementedError("forward AD (torch.autograd.forward_ad) through scan on the card: use torch.func.jvp "
                                  "or torch.func.jacfwd, whose JVP graphs scan replays")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _GradScan.apply(body, key, length, len(carry), *tensors)
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


@contextlib.contextmanager
def switch(name: str, value):
    """Inside the block, ``switched(name)`` is ``value``, for the bodies
    that read it; the graphs of a body are captured and replayed under the
    switches in force, which are part of their signature."""
    saved = _switches.get(name, _switches)
    _switches[name] = value
    try:
        yield
    finally:
        if saved is _switches:
            del _switches[name]
        else:
            _switches[name] = saved


def switched(name: str, default=False):
    """The value :func:`switch` gives ``name`` here, else ``default``."""
    return _switches.get(name, default)


@contextlib.contextmanager
def _switches_as(saved: Dict[str, object]):
    """Inside the block, the switches are ``saved`` (a backward runs under
    its forward's, wherever it is called)."""
    global _switches
    current, _switches = _switches, dict(saved)
    try:
        yield
    finally:
        _switches = current


def _entry(body, carry, consts, key, device, chunk) -> "_Entry":
    signature = (key, _shapes(carry), _shapes(consts), device, chunk, tuple(sorted(_switches.items())))
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
        ctx.switches = dict(_switches)
        ctx.mark_non_differentiable(*(t for t in out if not t.is_floating_point()))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *carry_bar):
        with _switches_as(ctx.switches):
            vjp = _vjp_entry(ctx.body, ctx.inputs[0], ctx.consts, ctx.key, ctx.device)
            carry_bar, consts_bar = vjp.run(ctx.inputs, ctx.consts, carry_bar)
        del ctx.inputs
        return (None, None, None, None, *carry_bar, *consts_bar)


class _TransformScan(torch.autograd.Function):
    """``scan`` on the card under torch.func transforms: the forward replays the body's graphs; the JVP, vmap and backward rules
    scan transformed bodies (module docstring)."""

    @staticmethod
    def forward(body, key, length, chunk, n_carry, *tensors):
        carry, consts = tensors[:n_carry], tensors[n_carry:]
        return _entry(body, carry, consts, key, tensors[0].device, chunk).run(body, carry, consts, length)

    @staticmethod
    def setup_context(ctx, inputs, output):
        body, key, length, chunk, n_carry, *tensors = inputs
        ctx.body, ctx.key, ctx.length, ctx.chunk, ctx.n_carry = body, key, length, chunk, n_carry
        ctx.switches = dict(_switches)
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)
        ctx.mark_non_differentiable(*(t for t in output if not t.is_floating_point()))

    @staticmethod
    def jvp(ctx, _body, _key, _length, _chunk, _n_carry, *tangents):
        tensors = ctx.saved_tensors
        carry, consts = tensors[: ctx.n_carry], tensors[ctx.n_carry :]
        carry_mask = tuple(t.is_floating_point() for t in carry)
        const_mask = tuple(t.is_floating_point() and d is not None for t, d in zip(consts, tangents[ctx.n_carry :]))
        carry_dot = tuple(torch.zeros_like(t) if d is None else d
                          for t, d, m in zip(carry, tangents[: ctx.n_carry], carry_mask) if m)
        const_dot = tuple(d for d, m in zip(tangents[ctx.n_carry :], const_mask) if m)
        jbody = functools.partial(_jvp_body, ctx.body, carry_mask, const_mask)
        out = _card_scan(jbody, carry + carry_dot, consts + const_dot, ctx.length, ("jvp", ctx.key, carry_mask, const_mask),
                         ctx.chunk, tensors[0].device)
        dots = iter(out[ctx.n_carry :])
        return tuple(next(dots) if m else None for m in carry_mask)

    @staticmethod
    def vmap(info, in_dims, body, key, length, chunk, n_carry, *tensors):
        size, dims = info.batch_size, in_dims[5:]
        carry = tuple((t.expand(size, *t.shape) if d is None else t.movedim(d, 0)).contiguous()
                      for t, d in zip(tensors[:n_carry], dims[:n_carry]))
        consts = tuple(t if d is None else t.movedim(d, 0).contiguous() for t, d in zip(tensors[n_carry:], dims[n_carry:]))
        const_dims = tuple(None if d is None else 0 for d in dims[n_carry:])
        vbody = functools.partial(_vmap_body, body, const_dims)
        out = _card_scan(vbody, carry, consts, length, ("vmap", key, const_dims, size), chunk, tensors[0].device)
        return out, (0,) * len(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *carry_bar):
        tensors = ctx.saved_tensors
        floating = [i for i, t in enumerate(tensors) if t.is_floating_point()]
        bars = tuple(torch.zeros_like(t) if g is None else g
                     for t, g in zip(tensors[: ctx.n_carry], carry_bar) if t.is_floating_point())
        with _switches_as(ctx.switches):
            grads = iter(_ScanVJP.apply(ctx.body, ctx.key, ctx.length, ctx.n_carry, len(tensors), *tensors, *bars))
        out = [None] * len(tensors)
        for i in floating:
            out[i] = next(grads)
        return (None,) * 5 + tuple(out)


def _jvp_body(body, carry_mask, const_mask, carry_all, consts_all):
    """One step of (carry, carry tangent) under ``torch.func.jvp`` of
    ``body``: the carry's floating entries and the consts that
    ``const_mask`` marks carry tangents (the latter constant)."""
    n_carry, n_consts = len(carry_mask), len(const_mask)
    carry, consts = list(carry_all[:n_carry]), list(consts_all[:n_consts])
    carry_dot, const_dot = carry_all[n_carry:], consts_all[n_consts:]
    carry_idx = [i for i, m in enumerate(carry_mask) if m]
    const_idx = [i for i, m in enumerate(const_mask) if m]

    def step(*primals):
        c, k = list(carry), list(consts)
        for j, i in enumerate(carry_idx):
            c[i] = primals[j]
        for j, i in enumerate(const_idx):
            k[i] = primals[len(carry_idx) + j]
        out = tuple(body(tuple(c), tuple(k)))
        return tuple(out[i] for i in carry_idx), tuple(o for o, m in zip(out, carry_mask) if not m)

    primals = tuple(carry[i] for i in carry_idx) + tuple(consts[i] for i in const_idx)
    out, out_dot, rest = torch.func.jvp(step, primals, tuple(carry_dot) + tuple(const_dot), has_aux=True)
    floats, others = iter(out), iter(rest)
    return tuple(next(floats) if m else next(others) for m in carry_mask) + tuple(out_dot)


def _vmap_body(body, const_dims, carry, consts):
    """One step of ``torch.func.vmap`` of ``body`` over the carry (batched
    on dim 0) and the consts batched where ``const_dims`` says 0."""
    return torch.func.vmap(lambda c, k: tuple(body(c, k)), in_dims=(0, const_dims))(tuple(carry), tuple(consts))


class _ScanVJP(torch.autograd.Function):
    """The backward of ``_TransformScan``: the adjoints of the first input
    carry's and the consts' floating entries for the adjoint of the last
    carry's floating entries. The forward replays the one-step graph to
    recover each step's input carry, then the one-step VJP graph in
    reverse; the vmap rule runs it once for each entry of the batch."""

    @staticmethod
    def forward(body, key, length, n_carry, n_tensors, *args):
        tensors, bars = args[:n_tensors], iter(args[n_tensors:])
        carry, consts = tensors[:n_carry], tensors[n_carry:]
        device = tensors[0].device
        inputs, _ = _entry(body, carry, consts, key, device, 1).run_keeping(body, carry, consts, length)
        carry_bar = tuple(next(bars) if t.is_floating_point() else None for t in carry)
        carry_bar, consts_bar = _vjp_entry(body, carry, consts, key, device).run(inputs, consts, carry_bar)
        return tuple(g for g in carry_bar + consts_bar if g is not None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, body, key, length, n_carry, n_tensors, *args):
        dims = in_dims[5:]
        rows = [_ScanVJP.apply(body, key, length, n_carry, n_tensors,
                               *(a if d is None else a.select(d, i) for a, d in zip(args, dims)))
                for i in range(info.batch_size)]
        out = tuple(torch.stack(col) for col in zip(*rows))
        return out, (0,) * len(out)


def _vjp_entry(body, carry, consts, key, device) -> "_VJP":
    signature = (key, _shapes(carry), _shapes(consts), device, tuple(sorted(_switches.items())))
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
    for (key, carry_shapes, *_), entry in _CACHE.items():
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
    for (key, carry_shapes, *_), entry in _VJP_CACHE.items():
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
