"""Device and host times of a call on the card, for chip_smoke.py and the
port's measuring tools."""

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
