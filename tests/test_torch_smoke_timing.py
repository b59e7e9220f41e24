"""``chip_smoke.timed_events``: which kernel events of a profiled window are
the timed calls, on made-up windows with the gaps the profiler leaves; and
``chip_smoke.events_dropped_only``: which geometry windows are run again."""

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


def s8_launches():
    """``gram_s8_launch``'s two records at a small shape, grids resolved."""
    from distributed_eigenspaces_tpu_torch.ops import gram as gram_mod

    return [la if la.grid else la.resolved((8, 1, 1))
            for la in gram_mod.gram_s8_launch(8, 1024, 784)]


def event(launch, **change):
    """The profiled event ``launch`` would give, with ``change`` applied."""
    return dict({"symbol": launch.kernel, "grid": launch.grid, "block": launch.block,
                 "smem": launch.smem}, **change)


@pytest.mark.parametrize("which, dropped_only", [
    ((), True),  # the window lost every event of the call
    ((1,), True),  # it lost the transpose's event
    ((0, 1), False),  # every event recorded
    ((0, 1, 1), False),  # an event more than the launches
])
def test_a_window_that_only_lacks_events_is_run_again(which, dropped_only):
    launches = s8_launches()
    events = [event(launches[i]) for i in which]
    assert cs.events_dropped_only(events, launches) is dropped_only


@pytest.mark.parametrize("change", [{"grid": (1, 1, 1)}, {"block": (32, 1, 1)},
                                    {"smem": 0}, {"symbol": "gram_bf16_tma_kernel"}])
def test_a_window_with_an_event_of_another_geometry_is_not_run_again(change):
    launches = s8_launches()
    assert not cs.events_dropped_only([event(launches[1], **change)], launches)
