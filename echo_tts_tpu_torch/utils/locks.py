"""FIFO ("fair") mutex for the serving engine's device lock (counterpart of
echo_tts_tpu/utils/locks.py).

CPython's `threading.Lock` has no acquisition-order guarantee: a thread that
releases and at once re-acquires in a loop usually wins against threads
already blocked in `acquire()`. The continuous scheduler
(serve/continuous.py) does exactly that, one group step a loop iteration,
so under sustained streaming load a plain lock would starve every other
device-path caller (one-shot `Engine.generate`, streams of other keys,
`set_lora`, warmup). FairLock hands the lock to waiters in strict arrival
order: release() wakes the queue head, and a re-acquiring caller lines up
behind it. One Condition round an acquire (microseconds) against device
steps of tens of milliseconds and more.
"""
from __future__ import annotations

import threading
from collections import deque


class FairLock:
    """Mutex with strict FIFO handoff. Context-manager compatible with
    `threading.Lock` (`with lock: ...`); not reentrant."""

    def __init__(self):
        self._cond = threading.Condition()
        self._waiters: deque = deque()
        self._held = False

    def acquire(self) -> bool:
        me = object()  # unique ticket
        with self._cond:
            self._waiters.append(me)
            while self._held or self._waiters[0] is not me:
                self._cond.wait()
            self._waiters.popleft()
            self._held = True
        return True

    def release(self) -> None:
        with self._cond:
            if not self._held:
                raise RuntimeError("release of unheld FairLock")
            self._held = False
            # every waiter re-checks and only the queue head proceeds; the
            # waiters are a few request threads
            self._cond.notify_all()

    def locked(self) -> bool:
        with self._cond:
            return self._held

    def __enter__(self) -> "FairLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
