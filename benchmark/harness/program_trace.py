"""A traced run of one cell with the program's own spans and counters
(`echo_tts_tpu_torch/utils/profiling.py`) read into its slice:

    python3 -m benchmark.harness.program_trace --workload <cell> --seed <n> --seconds 50 --trace 1

runs `benchmark/run.py` as it is, with the K1/K3 recorder and the traced
slice swapped for the two classes below: the recorder's `install()` turns
the program's recording on and `remove()` off; the slice snapshots the
program's counters at `start()` and `stop()`, drains its records in
`reduce()`, and labels each of the breakdown's idle gaps with the program
span open on the host at the time (the benchmark's own span where the
program had none open). The result line is the benchmark's, so relabelled;
standard error gets the idle time by program span and by kind, the share of
idle time under a program span, the counters' change over the slice, and
the readings of `READINGS`. The benchmark's own runs (`benchmark/run.py`)
leave the program's recording off.

The spans are stamped with `time.perf_counter_ns()`, the clock of the
slice's side markers, so a span maps onto the device timeline with the
slice's own offset. A program without spans (one older than them) reduces
as the benchmark's slice does, and every reading is then None.
"""
from __future__ import annotations

from benchmark import run  # first: its import time is the run's start

import heapq  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Sequence, Tuple  # noqa: E402

from benchmark.harness import profile  # noqa: E402
from benchmark.harness.readers import slice_start  # noqa: E402

# the kinds of span whose time the host spends on the device's behalf; a
# `wait` span (a client waiting on the engine) labels no gap
LABELLING = ("launch", "sync", "host")

# a span of the reduced slice: (name, kind, t0 s, t1 s, id, parent id, thread, attrs)
NAME, KIND, T0, T1, ID, PARENT = range(6)


def program():
    """The port's recorder module, or None where the port has none."""
    try:
        from echo_tts_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if all(hasattr(profiling, f) for f in ("enable", "drain", "counters")) \
        else None


class ProgramRecorder(profile.Recorder):
    """The K1/K3 recorder that also turns the program's recording on and off
    (`program`: None where the program has none)."""

    program = None

    def install(self):
        super().install()
        self.program = program()
        if self.program is not None:
            self.program.enable()

    def remove(self):
        super().remove()
        if self.program is not None:
            self.program.disable()


class ProgramSlice(profile.Slice):
    """The benchmark's slice, reduced with the program's records besides."""

    def __init__(self, recorder):
        super().__init__(recorder)
        self.program = getattr(recorder, "program", None)
        self.counters = [None, None]  # the program's, at start() and at stop()

    def start(self):
        super().start()
        if self.program is not None:
            self.counters[0] = self.program.counters()

    def stop(self):
        if self.program is not None:
            self.counters[1] = self.program.counters()
        super().stop()

    def reduce(self, spans) -> Dict:
        out = super().reduce(spans)
        if self.program is None:
            return out
        offset, spread, lo, hi, idle = window(profile._events(self.prof), self.t_host,
                                              self.t_start, self.t_stop)
        gaps = sorted(((b - a, (a + b) / 2, k) for k, (a, b) in enumerate(idle)), reverse=True)
        prog = reduced(self.program.drain(), idle, offset, (hi - lo) / 1e9, *self.counters,
                       (self.t_start, self.t_stop), named=[k for _, _, k in gaps[:10]])
        prog["dropped"] = self.program.counters().get("tracing.dropped", 0)
        prog["offset_spread_s"] = spread
        # the benchmark's gaps are these, longest first: keep its label where
        # no program span was open
        out["idle_gaps"] = [[label or old, g] for (old, g), label in
                            zip(out["idle_gaps"], prog["labels"])]
        out["program"] = prog
        return out


def window(ev, t_host: Sequence[float], t_start: float, t_stop: float):
    """(offset, its spread, lo, hi, idle) of a slice's device events ev
    (name, start ns, duration ns), found by the rules of `Slice.reduce`
    except the offset (device ns minus host ns): where every short marker
    was traced, the least of theirs, since a marker can only start late
    behind the program's kernels, and the spread of theirs besides (None
    otherwise). idle: the (start, end) device ns of each idle stretch of
    [lo, hi), in time order."""
    spins = [e for e in ev if profile._SLEEP in e[0]]
    side = [e for e in spins if e[2] < profile.Slice.MAIN_NS]
    main = [e for e in spins if e[2] >= profile.Slice.MAIN_NS]
    others = [e for e in ev if profile._SLEEP not in e[0]]
    offs = [d[1] - int(h * 1e9) for d, h in zip(side, t_host)]
    spread = None
    if side and len(side) == len(t_host):
        offset, spread = min(offs), (max(offs) - min(offs)) / 1e9
    elif side:
        offset = side[-1][1] - int(t_host[-1] * 1e9)
    else:
        offset = (main or others)[0][1] - int(t_start * 1e9)
    lo = main[0][1] if main else (side[-1][1] if side else others[0][1])
    hi = lo + int((t_stop - t_start) * 1e9)
    idle, cur_e = [], lo
    for _, st, du in (e for e in others if lo <= e[1] < hi):
        if st > cur_e:
            idle.append((cur_e, st))
        cur_e = max(cur_e, st + du)
    if hi > cur_e:
        idle.append((cur_e, hi))
    return offset, spread, lo, hi, idle


def attribute(gaps: Sequence[Tuple[int, int]], spans: Sequence[tuple]):
    """Idle time by the program span open over it. gaps: (start, end) host
    ns, in time order and disjoint; spans: records with name, kind, t0, t1
    (host ns) at NAME, KIND, T0, T1. Over every stretch of a gap the label
    is the open span of a LABELLING kind that started last: the innermost
    of its thread, and of the threads that have one the latest. Returns
    (for each gap {name: ns}, {name: ns}, {kind: ns}); time under no such
    span is under the name and kind None."""
    live = sorted((s for s in spans if s[KIND] in LABELLING and s[T1] > s[T0]),
                  key=lambda s: s[T0])
    heap: List[tuple] = []  # (-t0, t1, i): the latest started on top
    i, n = 0, len(live)
    per_gap, by_name, by_kind = [], {}, {}
    for lo, hi in gaps:
        got: Dict[Optional[str], int] = {}
        cur = lo
        while cur < hi:
            while i < n and live[i][T0] <= cur:
                heapq.heappush(heap, (-live[i][T0], live[i][T1], i))
                i += 1
            while heap and heap[0][1] <= cur:
                heapq.heappop(heap)
            nxt = live[i][T0] if i < n else hi
            if heap:
                top = live[heap[0][2]]
                end = min(hi, top[T1], nxt)
                name, kind = top[NAME], top[KIND]
            else:
                end, name, kind = min(hi, nxt), None, None
            got[name] = got.get(name, 0) + end - cur
            by_name[name] = by_name.get(name, 0) + end - cur
            by_kind[kind] = by_kind.get(kind, 0) + end - cur
            cur = end
        per_gap.append(got)
    return per_gap, by_name, by_kind


def reduced(records, gaps_dev: Sequence[Tuple[int, int]], offset: int, window_s: float,
            c0: Optional[dict], c1: Optional[dict], host_slice: Tuple[float, float],
            named: Sequence[int] = ()) -> Dict:
    """The program's part of a reduced slice: its spans (seconds on the
    host clock), the slice's idle seconds by span name and by kind, the
    share of idle time under a labelling span, the counters' change over
    the slice (c0 at its start, c1 at its stop), and the `label` of each
    gap whose index is in `named`. gaps_dev: (start, end) device ns, in
    time order; offset: device ns minus host ns."""
    spans = [(r.name, r.kind, r.t0 * 1e-9, r.t1 * 1e-9, r.id, r.parent, r.thread, r.attrs)
             for r in records]
    host_gaps = [(a - offset, b - offset) for a, b in gaps_dev]
    raw = [(r.name, r.kind, r.t0, r.t1) for r in records]
    per_gap, by_name, by_kind = attribute(host_gaps, raw)
    idle = sum(b - a for a, b in gaps_dev)
    counters = {k: v - (c0 or {}).get(k, 0) for k, v in (c1 or {}).items()}
    return {
        "spans": spans,
        "labels": [label(per_gap[i]) for i in named],
        "idle_by_name": {str(k): v * 1e-9 for k, v in by_name.items()},
        "idle_by_kind": {str(k): v * 1e-9 for k, v in by_kind.items()},
        "covered_pct": 100.0 * (1 - by_kind.get(None, 0) / idle) if idle else None,
        "idle_s": idle * 1e-9,
        "window_s": window_s,
        "counters": counters,
        "slice_host": list(host_slice),
    }


def label(got: Dict[Optional[str], int]) -> Optional[str]:
    """The span name over most of one gap (None: no program span)."""
    named = {k: v for k, v in got.items() if k is not None}
    if not named or max(named.values()) < got.get(None, 0):
        return None
    return max(named, key=named.get)


# -- readings of a run's record ----------------------------------------------
def _prog(rec: dict) -> Optional[dict]:
    tr = rec.get("trace")
    return tr.get("program") if tr else None


def idle_under(rec: dict, kind: str) -> Optional[float]:
    """Per cent of the traced slice during which the device was idle while
    the host was inside a program span of `kind`."""
    p = _prog(rec)
    if not p or not p["window_s"]:
        return None
    return 100.0 * p["idle_by_kind"].get(kind, 0.0) / p["window_s"]


def spans_under(spans: list, name: str, root: str) -> List[tuple]:
    """(span, its `root` ancestor) for every span called `name` with one."""
    by_id = {s[ID]: s for s in spans}
    out = []
    for s in spans:
        if s[NAME] != name:
            continue
        up = by_id.get(s[PARENT])
        while up is not None and up[NAME] != root:
            up = by_id.get(up[PARENT])
        if up is not None:
            out.append((s, up))
    return out


def per_step(rec: dict, counter: str, step: str) -> Optional[float]:
    """A counter's change over the slice over the `step` spans that ended
    inside it."""
    p = _prog(rec)
    if not p or counter not in p["counters"]:
        return None
    lo, hi = p["slice_host"]
    steps = sum(1 for s in p["spans"] if s[NAME] == step and lo <= s[T1] <= hi)
    return p["counters"][counter] / steps if steps else None


def prep_s_per_batch(rec: dict) -> Optional[float]:
    """Mean length of the `pipeline.prepare` spans (tokenize, speaker lookup
    or encode of every row, stacking, the noise draw) inside the
    `engine.batch` spans that started after the window's start and ended
    before the traced slice began (the profiler stalls the host inside it)."""
    p = _prog(rec)
    if not p or "t0" not in rec:
        return None
    a, b = rec["t0"], slice_start(rec)
    got = [s[T1] - s[T0] for s, batch in spans_under(p["spans"], "pipeline.prepare",
                                                       "engine.batch")
           if batch[T0] >= a and batch[T1] <= b]
    return statistics.mean(got) if got else None


# each None where the cell's program has no such spans: the one-shot cell
# reads the first two, the stream cell the second, the training cell the last two
READINGS = {
    "prep_s_per_batch": prep_s_per_batch,
    "idle_launch_pct": lambda rec: idle_under(rec, "launch"),
    "host_syncs_per_step": lambda rec: per_step(rec, "train.host_syncs", "train.step"),
}


def report(rec: dict, err=None) -> Dict[str, float]:
    """Print the program's side of a traced run's record on `err` (standard
    error by default); returns the readings that are not None."""
    err = err or sys.stderr
    got = {k: f(rec) for k, f in READINGS.items()}
    got = {k: v for k, v in got.items() if v is not None}
    p = _prog(rec)
    if p is None:
        print("# program spans: none (untraced, off the card, or a program without them)",
              file=err)
        return got
    top = sorted(p["idle_by_name"].items(), key=lambda x: -x[1])[:12]
    lo, hi = p["slice_host"]
    inside: Dict[str, int] = {}
    for sp in p["spans"]:
        if lo <= sp[T0] < hi:
            inside[sp[NAME]] = inside.get(sp[NAME], 0) + 1
    print(f"# program spans: {len(p['spans'])}, idle {p['idle_s']:.4f} s of "
          f"{p['window_s']:.4f}, under a program span {p['covered_pct']}%, "
          f"side-marker offset spread {p['offset_spread_s']} s", file=err)
    print(f"# idle s by kind: {p['idle_by_kind']}", file=err)
    print(f"# idle s by span: {dict(top)}", file=err)
    print(f"# program spans begun in the slice: {inside}", file=err)
    print(f"# program counters over the slice: {p['counters']}; records the ring "
          f"dropped (tracing.dropped): {p['dropped']}", file=err)
    print(f"# program readings: {got}", file=err)
    return got


def main(argv=None, **kw) -> int:
    """`benchmark/run.py`'s main (its keywords pass through) with the
    program's spans read into the traced slice."""
    from benchmark.runners import common, train_steps

    was = common.Recorder, common.Slice, train_steps.Slice
    common.Recorder = ProgramRecorder
    common.Slice = train_steps.Slice = ProgramSlice
    got = {}
    tweak = kw.pop("tweak", None)

    def capture(cell):
        if tweak is not None:
            tweak(cell)
        runner = cell.runner()

        class Captured:
            @staticmethod
            def run(ctx):
                got["rec"] = runner.run(ctx)
                return got["rec"]

        cell.runner = lambda: Captured

    try:
        rc = run.main(argv, tweak=capture, **kw)
    finally:
        common.Recorder, common.Slice, train_steps.Slice = was
    if "rec" in got:
        report(got["rec"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
