"""Streams over dispatches in the window: streams whose first chunks came
together were dispatched together (the engine counts only batches of two or
more, so the benchmark groups them itself)."""


def read(rec):
    starts = sorted(rec.get("first_chunk_at", []))
    if not starts:
        return None
    groups = 1 + sum(1 for a, b in zip(starts, starts[1:]) if b - a > 0.05)
    return len(starts) / groups
