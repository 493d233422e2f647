"""The program's spans in a traced slice (`harness/program_trace.py`) and the
readings of them, on synthetic device events and records: no card needed."""
from __future__ import annotations

import collections
import io
import json

import pytest

from benchmark.harness import profile, program_trace
from benchmark.harness.spans import Spans
from benchmark.runners import common, train_steps
from benchmark.tests.test_bench_run import tiny

Rec = collections.namedtuple("Rec", "id parent name kind t0 t1 thread attrs")
OFF = 7_000_000_000_000  # device ns minus host ns
MS = 1_000_000
H0 = 1_000_000_000_000  # the host ns of the slice's start


class FakeProgram:
    def __init__(self, records, end_counters):
        self.records, self.end = records, end_counters

    def drain(self):
        out, self.records = self.records, []
        return out

    def counters(self):
        return dict(self.end)


def _slice(monkeypatch, records, spans=None, late=(0,)):
    """A slice of 100 ms whose device ran [0, 10), [30, 40) and [70, 100) ms
    after its start: idle 20 ms, then 30 ms. A side marker a `late` entry,
    launched 10 ms apart (each waited for before the next) and started that
    many ns late."""
    lo = H0 + OFF
    sent = [H0 - (30 - 10 * k) * MS for k in range(len(late))]
    events = [("spin_kernel", h + OFF + d, 15_000) for h, d in zip(sent, late)]
    events += [("spin_kernel", lo, 60_000), ("spin_kernel", lo + 70_000, 60_000),
               ("gemm", lo, 10 * MS), ("gemm", lo + 30 * MS, 10 * MS),
               ("gemm", lo + 70 * MS, 30 * MS)]
    monkeypatch.setattr(profile, "_events", lambda prof: sorted(events, key=lambda e: e[1]))
    sl = program_trace.ProgramSlice.__new__(program_trace.ProgramSlice)
    sl.rec, sl.prof = None, None
    sl.program = None if records is None else FakeProgram(
        records, {"train.host_syncs": 7, "tracing.dropped": 0})
    sl.t_host = [h / 1e9 for h in sent]
    sl.t_begin, sl.t_start, sl.t_stop = (H0 - 5 * MS) / 1e9, H0 / 1e9, (H0 + 100 * MS) / 1e9
    sl.start_cost_s = sl.stop_cost_s = 0.0
    sl.counters = [{"train.host_syncs": 1}, {"train.host_syncs": 7}]
    return sl.reduce(spans)


def test_idle_gaps_take_the_program_span_open_then(monkeypatch):
    me, other = 1, 2
    records = [
        # the sampler's step spans the first gap on one thread...
        Rec(1, 0, "sampler.step", "launch", H0 + 5 * MS, H0 + 35 * MS, me, {}),
        # ...and a later-started host span on another thread takes 5 ms of it
        Rec(2, 0, "pipeline.prepare", "host", H0 + 20 * MS, H0 + 25 * MS, other, {}),
        # a client's wait labels nothing: the second gap keeps the benchmark's label
        Rec(3, 0, "engine.queue", "wait", H0 + 35 * MS, H0 + 90 * MS, other, {}),
    ]
    spans = Spans()
    spans.items.append(("generate", H0 / 1e9, (H0 + 100 * MS) / 1e9))
    # the second of three side markers started 4 ms late: the least offset holds
    out = _slice(monkeypatch, records, spans, late=(0, 4 * MS, 0))
    assert out["busy_s"] == pytest.approx(0.050) and out["window_s"] == pytest.approx(0.1)
    assert out["idle_gaps"] == [["generate", pytest.approx(0.030)],
                                ["sampler.step", pytest.approx(0.020)]]
    p = out["program"]
    assert p["idle_by_name"] == {"sampler.step": pytest.approx(0.015),
                                 "pipeline.prepare": pytest.approx(0.005),
                                 "None": pytest.approx(0.030)}
    assert p["idle_by_kind"] == {"launch": pytest.approx(0.015), "host": pytest.approx(0.005),
                                 "None": pytest.approx(0.030)}
    assert p["covered_pct"] == pytest.approx(40.0)
    assert p["counters"] == {"train.host_syncs": 6}
    assert p["dropped"] == 0 and p["offset_spread_s"] == pytest.approx(0.004)
    assert [s[0] for s in p["spans"]] == ["sampler.step", "pipeline.prepare", "engine.queue"]
    assert p["spans"][0][2] == pytest.approx(H0 / 1e9 + 0.005)
    err = io.StringIO()
    assert program_trace.report({"trace": out}, err) == {"idle_launch_pct": pytest.approx(15.0)}
    assert "under a program span 40.0" in err.getvalue()


def test_a_program_without_spans_keeps_the_benchmark_labels(monkeypatch):
    """A program older than its spans: the slice reduces as the benchmark's."""
    spans = Spans()
    spans.items.append(("train step", H0 / 1e9, (H0 + 100 * MS) / 1e9))
    out = _slice(monkeypatch, None, spans)
    assert [g[0] for g in out["idle_gaps"]] == ["train step", "train step"]
    assert "program" not in out
    assert program_trace.report({"trace": out}, io.StringIO()) == {}
    assert program_trace.program() is not None  # this port has them


def test_window_without_every_side_marker_takes_the_last():
    ev = [("spin_kernel", 5_000, 15_000), ("spin_kernel", 100_000, 60_000),
          ("gemm", 100_000, 10_000), ("gemm", 150_000, 50_000)]
    offset, spread, lo, hi, idle = program_trace.window(ev, [1e-6, 2e-6], 0.0, 1e-4)
    assert (offset, spread, lo, hi) == (5_000 - 2_000, None, 100_000, 200_000)
    assert idle == [(110_000, 150_000)]


def test_attribute_stretches_and_nesting():
    spans = [("outer", "host", 0, 100), ("inner", "launch", 10, 20), ("late", "sync", 90, 200),
             ("client", "wait", 0, 300)]
    per_gap, by_name, by_kind = program_trace.attribute([(5, 15), (18, 95), (250, 260)], spans)
    assert per_gap == [{"outer": 5, "inner": 5}, {"inner": 2, "outer": 70, "late": 5},
                       {None: 10}]
    assert by_kind == {"host": 75, "launch": 7, "sync": 5, None: 10}
    assert program_trace.label(per_gap[1]) == "outer" and program_trace.label(per_gap[2]) is None


@pytest.mark.parametrize("prog,want", [
    ({"idle_by_kind": {"launch": 0.5, "host": 0.25}, "window_s": 4.0}, 12.5),
    ({"idle_by_kind": {"host": 1.0}, "window_s": 4.0}, 0.0),
    (None, None),  # a program without spans
])
def test_idle_launch_reading(prog, want):
    read = program_trace.READINGS["idle_launch_pct"]
    trace = {"busy_s": 1.0, "window_s": 4.0}
    if prog is not None:
        trace["program"] = prog
    assert read({"trace": trace}) == (pytest.approx(want) if want is not None else None)
    assert read({"trace": None}) is None


def _span(name, t0, t1, sid, parent=0):
    return (name, "host", t0, t1, sid, parent, 1, {})


def test_prep_s_per_batch_reading():
    read = program_trace.READINGS["prep_s_per_batch"]
    spans = [_span("engine.batch", 1.0, 6.0, 1), _span("pipeline.prepare", 1.0, 1.5, 2, 1),
             _span("engine.batch", 12.0, 17.0, 3), _span("pipeline.prepare", 12.0, 12.3, 4, 3),
             _span("codec.encode", 12.0, 12.2, 5, 4),
             _span("engine.batch", 0.0, 0.9, 6), _span("pipeline.prepare", 0.0, 0.2, 7, 6),
             _span("engine.batch", 29.0, 35.0, 8), _span("pipeline.prepare", 29.0, 29.9, 9, 8),
             _span("pipeline.prepare", 20.0, 20.7, 10)]  # a solo call, no batch
    rec = {"t0": 0.95, "trace": {"host_from": 30.0, "program": {"spans": spans}}}
    assert read(rec) == pytest.approx(0.4)
    assert read(dict(rec, t0=20.0)) is None  # no batch between the window's start and the slice
    assert read({"t0": 0.0, "trace": {"host_from": 30.0}}) is None
    assert read({"t0": 0.0, "trace": None}) is None


def test_host_syncs_per_step_reading():
    read = program_trace.READINGS["host_syncs_per_step"]
    spans = [_span("train.step", t - 1, t, i) for i, t in enumerate((2.0, 5.0, 8.0, 12.0))]
    prog = {"spans": spans, "counters": {"train.host_syncs": 9}, "slice_host": [1.5, 10.0]}
    assert read({"trace": {"program": prog}}) == pytest.approx(3.0)
    assert read({"trace": {"program": dict(prog, counters={})}}) is None
    assert read({"trace": {"program": dict(prog, slice_host=[20.0, 30.0])}}) is None
    assert read({"trace": None}) is None


def test_recorder_turns_the_programs_recording_on_and_off():
    from echo_tts_tpu_torch.ops import joint_attention as ja
    from echo_tts_tpu_torch.utils import profiling

    fwd = ja._joint_attention_cuda
    r = program_trace.ProgramRecorder()
    r.install()
    try:
        assert profiling._on and ja._joint_attention_cuda is not fwd
    finally:
        r.remove()
    assert not profiling._on and ja._joint_attention_cuda is fwd


def test_main_runs_the_benchmark_and_puts_its_classes_back(capsys):
    """Off the card no slice is traced: the result line is the benchmark's,
    and the program's side says it has nothing."""
    was = common.Recorder, common.Slice, train_steps.Slice
    out = io.StringIO()
    rc = program_trace.main(["--workload", "oneshot-b8-closed16", "--seed", str(2**31 + 11),
                             "--seconds", "1.5", "--trace", "1"], device="cpu", tweak=tiny,
                            out=out)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] > 0
    assert (common.Recorder, common.Slice, train_steps.Slice) == was
    assert "# program spans: none" in capsys.readouterr().err
