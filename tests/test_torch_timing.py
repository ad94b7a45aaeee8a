"""``tds_tpu_torch.utils.timing.counted_trace``'s rule for retaking a
torch.profiler trace that lost records, on made-up traces: a trace that
counts other than expected is taken again while each new one holds more
device events than the one before, and the fullest trace's count is the
one returned. The traces themselves need the card; the rule does not."""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.utils.timing import counted_trace  # noqa: E402


def _fake_traces(shapes):
    """A ``trace`` argument that returns, call by call, traces of (events,
    kernels among them) from ``shapes``, with the call's index as its
    result; and the list of the calls made."""
    calls = []

    def trace(fn):
        events, kernels = shapes[len(calls)]
        calls.append(fn())
        named = [SimpleNamespace(name="pgs_kernel_f32") for _ in range(kernels)]
        return named + [SimpleNamespace(name="elementwise") for _ in range(events - kernels)], len(calls) - 1, 0.5

    return trace, calls


@pytest.mark.parametrize(
    "shapes, returned, taken",
    [
        ([(100, 20)], (100, 20, 0), 1),  # complete at once
        ([(61, 19), (100, 20)], (100, 20, 1), 2),  # lost records, retaken
        ([(61, 19), (80, 19), (100, 20)], (100, 20, 2), 3),  # lost twice
        ([(100, 19), (100, 19)], (100, 19, 0), 2),  # the fullest counts 19: the caller fails
        ([(100, 19), (61, 20)], (100, 19, 0), 2),  # a thinner retake does not decide
        ([(61, 19), (70, 19), (80, 19), (90, 19), (100, 20)], (90, 19, 3), 4),  # at most 4 traces
    ],
)
def test_a_trace_that_lost_records_is_retaken_and_the_fullest_decides(shapes, returned, taken):
    trace, calls = _fake_traces(shapes)
    events, out, seconds, count = counted_trace(lambda: "run", "pgs_kernel", 20, trace=trace)
    assert (len(events), count, out) == returned and seconds == 0.5
    assert calls == ["run"] * taken
