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
"""

import contextlib
import ctypes
import functools
import time
from typing import Callable, Dict, NamedTuple, Sequence

import torch

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
    if length == 0:
        return carry
    if torch.is_grad_enabled() and any(t.requires_grad for t in carry + consts):
        raise RuntimeError(
            "a replayed CUDA graph records no autograd graph, so scan on the card would drop gradients; "
            "call it under torch.no_grad() (gradients are ROADMAP Queue 1 item 5)"
        )
    signature = (key, _shapes(carry), _shapes(consts), device, chunk)
    entry = _CACHE.get(signature)
    if entry is None:
        entry = _CACHE[signature] = _Entry(body, carry, consts, device, chunk)
    return entry.run(body, carry, consts, length)


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
    """A :class:`GraphStats` for every cached graph, in capture order."""
    out = []
    for (key, carry_shapes, _, _, _), entry in _CACHE.items():
        batch = carry_shapes[0][0][0] if carry_shapes and carry_shapes[0][0] else 0
        for graph in entry.graphs.values():
            out.append(GraphStats(key, batch, graph.steps, graph.nodes, graph.capture_s, graph.instantiate_s))
    return out


def clear():
    """Drops every cached graph, its buffers and its memory pool."""
    _CACHE.clear()


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


_CACHE: Dict[tuple, _Entry] = {}


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
