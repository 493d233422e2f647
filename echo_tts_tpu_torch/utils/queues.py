"""Producer/consumer queue discipline (counterpart of
echo_tts_tpu/utils/queues.py): a bounded handoff that gives up when the
consumer abandons the stream, so a producer never blocks forever on a full
queue (training batch prefetch)."""
from __future__ import annotations

import queue as _queue
import threading


def put_until_abandoned(q: "_queue.Queue", item, abandoned: threading.Event,
                        poll_s: float = 0.1) -> bool:
    """Bounded q.put that returns False (dropping the item) once `abandoned`
    is set; without it a consumer that stops draining leaves the producer
    blocked on a full queue for the life of the process."""
    while not abandoned.is_set():
        try:
            q.put(item, timeout=poll_s)
            return True
        except _queue.Full:
            continue
    return False


def drain(q: "_queue.Queue") -> None:
    """Empty a queue without blocking (unblocks a producer mid-put)."""
    while True:
        try:
            q.get_nowait()
        except _queue.Empty:
            return
