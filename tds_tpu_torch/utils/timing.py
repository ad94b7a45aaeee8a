"""Device and host times of a call on the card, and the kernels of a
torch.profiler trace of it, for chip_smoke.py, the port's measuring tools
and its card tests."""

import statistics
import time

import torch


def device_ms(fn, rounds, per_round, backlog_ms=20):
    """Median device time (ms) of one call of ``fn``, from CUDA events
    around each of ``rounds * per_round`` calls. In each round a sleep
    kernel queued first keeps the stream busy while the host enqueues, so
    the host's own time per call is not counted. A round must stay under
    the launch queue's depth (about a thousand operations), or the host
    blocks until the device drains it; the check below finds that too."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(per_round)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(per_round)]
        slept = torch.cuda.Event()
        torch.cuda._sleep(int(backlog_ms * 2e6))  # cycles; at most 2 GHz, so >= backlog_ms
        slept.record()
        for start, end in zip(starts, ends):
            start.record()
            fn()
            end.record()
        if slept.query():
            raise RuntimeError("the device went idle while the host enqueued; no device time measured")
        torch.cuda.synchronize()
        times += [s.elapsed_time(e) for s, e in zip(starts, ends)]
    return statistics.median(times)


def wall_ms(fn, reps):
    """Host wall time (ms) of one call, enqueue and run, over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_trace(fn, pad_s=0.25):
    """(the device events of a torch.profiler trace of ``fn()``, its result,
    its seconds up to the synchronise that ends it). The trace opens
    ``pad_s`` of host sleep before the call and closes ``pad_s`` after that
    synchronise: the profiler receives a kernel's record some time after the
    kernel ends, and a trace stopped at once can lose the last kernels'. The
    seconds leave the padding out. An event is a pair (name, duration in
    us), read from the profiler's raw records rather than its event tree,
    whose Python objects take seconds for a trace of ~100,000 operations.
    ``kineto_results`` is private to torch.profiler and may change between
    torch versions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        time.sleep(pad_s)
    events = [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return events, out, seconds


def counted_trace(fn, kernel, expected, tries=4, trace=device_trace):
    """(device events, result, seconds) of ``trace(fn)``, and the number of
    kernels whose name holds ``kernel`` in those events. The profiler can
    lose records from a trace (a few of tens of thousands when the host is
    busy), so a trace that counts other than ``expected`` is taken again, up
    to ``tries`` traces, while each new one holds more device events than
    the one before: the fullest trace's count is returned, and the caller
    holds it to ``expected``. ``fn`` must launch the same work at every
    call."""
    fullest = None
    for _ in range(tries):
        events, out, seconds = trace(fn)
        if fullest is not None and len(events) <= len(fullest[0]):
            break
        fullest = (events, out, seconds, sum(1 for name, _ in events if kernel in name))
        if fullest[3] == expected:
            break
    return fullest
