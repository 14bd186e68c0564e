"""``joshupscale_torch.tools.timing.busy_parts``: the device's busy time
in a trace's kernel records, split by part, where records overlap (a
launch with programmatic dependent launch starts before the one it
follows ends and waits) -- pure Python, no card."""

import pytest

from joshupscale_torch.tools.timing import busy_parts


def _group(name):
    return name.split(":")[0]


@pytest.mark.parametrize("events,want", [
    # Back to back: the parts are the records' durations (µs -> ms).
    ([("K1:a", 0, 10), ("K2:a", 12, 3), ("K1:b", 20, 5)],
     {"K1": 0.015, "K2": 0.003}),
    # A K1 that starts 4 µs before the K1 it follows ends counts from
    # that end: 10 + 6 µs busy, not 10 + 10.
    ([("K1:a", 0, 10), ("K1:b", 6, 10)], {"K1": 0.016}),
    # A record inside an earlier one adds nothing; a later part that
    # overlaps another part's tail counts past it only.
    ([("K1:a", 0, 20), ("other:a", 5, 5), ("K2:a", 18, 4)],
     {"K1": 0.020, "other": 0.0, "K2": 0.002}),
])
def test_busy_parts_counts_overlap_once(events, want):
    """The parts, from records in any order, and their sum: the length
    of the union of the records' intervals."""
    records = [{"name": n, "ts": ts, "dur": dur} for n, ts, dur in events]
    got = busy_parts(list(reversed(records)), _group)
    assert got == pytest.approx(want)
    covered = {us for _, ts, dur in events for us in range(ts, ts + dur)}
    assert sum(got.values()) == pytest.approx(len(covered) / 1e3)
