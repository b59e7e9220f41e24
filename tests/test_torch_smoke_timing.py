"""``chip_smoke.timed_events``: which kernel events of a profiled window are
the timed calls, on made-up windows with the gaps the profiler leaves."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

PAUSE_US = cs.PAUSE_S * 1e6
REPS = 20


def window(parts):
    """Events from ``parts``: a list of (names of one call, calls), with a
    pause between parts; 10 us kernels, 2 us apart."""
    events, t = [], 0.0
    for i, (names, calls) in enumerate(parts):
        if i:
            t += PAUSE_US
        for _ in range(calls):
            for name in names:
                events.append(SimpleNamespace(name=name, time_range=SimpleNamespace(
                    start=t, end=t + 10.0)))
                t += 12.0
    return events


FILL = (("fill", "reduce"), 4)
K = ("kernel",)


@pytest.mark.parametrize("parts, launches, timed", [
    ([FILL, (K, 5), (K, REPS)], 1, REPS),  # every event recorded
    ([((("reduce",)), 1), (("fill", "reduce"), 3), (K, 5), (K, REPS)], 1, REPS),
    ([FILL, (K, REPS)], 1, REPS),  # every warm call left out
    ([(K, REPS)], 1, REPS),  # every event before the timed calls left out
    ([(("a", "b"), 5), (("a", "b"), REPS)], None, 2 * REPS),  # a library call of two kernels
])
def test_timed_events_are_the_calls_after_the_last_pause(parts, launches, timed):
    events = window(parts)
    measured, cut = cs.timed_events(events, REPS, launches)
    assert measured == events[-timed:]
    assert cut == len(events) - timed


@pytest.mark.parametrize("parts, launches", [
    ([FILL, (K, 5), (K, REPS - 1)], 1),  # a timed call left out
    ([FILL, (K, 5)], 1),  # every timed call left out: the warm calls are not taken
    ([(K, REPS - 5)], 1),  # the timed calls' head left out with all before them
    ([FILL, (("a", "b"), 5), (("a", "b"), REPS), (("b",), 1)], None),  # a stray kernel last
])
def test_timed_events_refuse_a_window_that_lacks_an_event(parts, launches):
    assert cs.timed_events(window(parts), REPS, launches)[0] is None
