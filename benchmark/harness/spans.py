"""Host spans recorded by the benchmark around its own calls into the
program (a client's request, a wait for the next chunk, `next()` on the
training data, a training step), kept in memory on the host clock."""
from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Tuple


class Spans:
    def __init__(self):
        self._mu = threading.Lock()
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._mu:
                self.items.append((name, t0, t1))

    def label_at(self, t: float) -> Optional[str]:
        """The span open at host time t that started last, with the number
        of spans of its name open then."""
        with self._mu:
            open_ = [(t0, n) for n, t0, t1 in self.items if t0 <= t <= t1]
        if not open_:
            return None
        name = max(open_)[1]
        k = sum(1 for _, n in open_ if n == name)
        return name if k == 1 else f"{name} ({k} open)"
