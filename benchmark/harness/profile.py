"""The traced slice of a window: a `torch.profiler` capture of the device's
activity over a bounded stretch, reduced to busy and idle time, the device
operations that took most time, the longest idle gaps labelled by the
benchmark's host span open at the time, and the joint-attention calls
(kernels K1 and K3) with the shapes and masks each was launched with.

Shapes come from a recorder around the program's two launch functions
(`ops/joint_attention.py:_joint_attention_cuda`, `_joint_attention_bwd_cuda`);
it takes a lock around each launch, so that a marker kernel launched on the
same stream under that lock splits the launches into "before the slice"
and "in it": the kernels of that stream run in launch order, so the n-th
K1 kernel after the marker is the n-th K1 call recorded after it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

from . import flops
from .families import family

_SLEEP = "spin_kernel"  # torch.cuda._sleep's kernel: the slice's markers


class Recorder:
    """Records each K1/K3 launch's shapes while `on`; installed by
    `install()`, removed by `remove()`."""

    def __init__(self):
        self.lock = threading.Lock()
        self.on = False
        self.calls = {"K1": [], "K3": []}
        self._orig = None

    def install(self):
        from echo_tts_tpu_torch.ops import joint_attention as ja

        orig_f, orig_b = ja._joint_attention_cuda, ja._joint_attention_bwd_cuda
        rec = self

        def fwd(q, k_self, v_self, segments, layout, self_len, out, lse=None):
            with rec.lock:
                rec._note("K1", q, layout, segments, self_len)
                return orig_f(q, k_self, v_self, segments, layout, self_len, out, lse)

        def bwd(q, k_self, v_self, segments, out, lse, do, layout):
            with rec.lock:
                rec._note("K3", q, layout, segments, None)
                return orig_b(q, k_self, v_self, segments, out, lse, do, layout)

        ja._joint_attention_cuda, ja._joint_attention_bwd_cuda = fwd, bwd
        self._orig = (ja, orig_f, orig_b)

    def remove(self):
        if self._orig is not None:
            ja, f, b = self._orig
            ja._joint_attention_cuda, ja._joint_attention_bwd_cuda = f, b
            self._orig = None

    def _note(self, kind, q, layout, segments, self_len):
        if not self.on:
            return
        if layout == "sm":
            g, b, s, h, d = q.shape
        else:
            g, b, h, s, d = q.shape
        self.calls[kind].append((g, b, h, s, d, [sg[2] for sg in segments], self_len))


def _bound(call, backward: bool):
    g, b, h, s, d, masks, self_len = call
    own = [s] * b if self_len is None else [int(x) for x in torch.as_tensor(self_len).reshape(-1)]
    per = [[own[i]] * g for i in range(b)]
    ctx = [0] * b
    for m in masks:
        valid = m if m.dtype == torch.bool else m > -1e29
        valid = valid.reshape(-1, b, valid.shape[-1])
        if valid.shape[0] == 1 and g > 1:
            valid = valid.expand(g, b, valid.shape[-1])
        cnt = valid.sum(-1).cpu().tolist()  # (G, B)
        union = valid.any(0).sum(-1).cpu().tolist()
        for i in range(b):
            for gi in range(g):
                per[i][gi] += cnt[gi][i]
            ctx[i] += union[i]
    ops, nbytes = flops.attention_call(g, per, h, s, d, ctx, backward=backward)
    return flops.bound_seconds(ops, nbytes)


def _events(prof) -> List[tuple]:
    """(name, start_ns, duration_ns) of every device activity."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
        for e in evs:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            st = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            du = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            out.append((e.name(), int(st), int(du)))
    except AttributeError:
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out.append((e.name, int(e.time_range.start * 1000),
                            int((e.time_range.end - e.time_range.start) * 1000)))
    out.sort(key=lambda x: x[1])
    return out


class Slice:
    """A bounded traced stretch of the window, started and stopped from any
    thread while the program runs on others.

    Two kinds of marker kernel (torch.cuda._sleep, told apart by length):
    short ones on a stream of the slice's own, launched one at a time and
    waited for, give the offset of the device's clock from the host's; two
    long ones on the program's stream, launched under the recorder's lock,
    open the slice in launch order. Each kind is launched more than once,
    since the tracer can miss a kernel as it comes up."""

    SIDE, MAIN = 20_000, 100_000  # cycles: ~10-20 us and ~50-90 us
    MAIN_NS = 30_000

    def __init__(self, recorder: Optional[Recorder]):
        self.rec = recorder
        self.prof = None
        self.side = torch.cuda.Stream()
        self.t_host: List[float] = []

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once around a small operation, so
        that its one-time initialisation falls in set-up, not in a window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1024, device="cuda").sum().item()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        t = self.t_begin = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        time.sleep(0.05)
        for _ in range(3):
            with torch.cuda.stream(self.side):
                self.t_host.append(time.perf_counter())
                torch.cuda._sleep(self.SIDE)
            self.side.synchronize()
        lock = self.rec.lock if self.rec is not None else threading.Lock()
        with lock:
            torch.cuda._sleep(self.MAIN)
            torch.cuda._sleep(self.MAIN)
            if self.rec is not None:
                self.rec.on = True
        self.t_start = time.perf_counter()
        self.start_cost_s = self.t_start - t

    def stop(self):
        self.t_stop = time.perf_counter()
        if self.rec is not None:
            with self.rec.lock:
                self.rec.on = False
        torch.cuda.synchronize()
        self.prof.stop()
        self.stop_cost_s = time.perf_counter() - self.t_stop

    def reduce(self, spans) -> Dict:
        ev = _events(self.prof)
        spins = [e for e in ev if _SLEEP in e[0]]
        side = [e for e in spins if e[2] < self.MAIN_NS]
        main = [e for e in spins if e[2] >= self.MAIN_NS]
        # the last short marker traced stands for the last one launched; a
        # kind the tracer missed altogether is stood in for by the other
        # (the slice's edge and the pairing of K1 calls then approximate:
        # "markers" in the result says so)
        others = [e for e in ev if _SLEEP not in e[0]]
        if side:
            offset = side[-1][1] - int(self.t_host[-1] * 1e9)  # device ns - host ns
        else:
            offset = (main or others)[0][1] - int(self.t_start * 1e9)
        lo = main[0][1] if main else (side[-1][1] if side else others[0][1])
        hi = lo + int((self.t_stop - self.t_start) * 1e9)
        ev = [e for e in ev if _SLEEP not in e[0] and e[1] >= lo and e[1] < hi]
        busy, gaps, cur_s, cur_e = 0, [], lo, lo
        for _, st, du in ev:
            if st > cur_e:
                busy += cur_e - cur_s
                gaps.append((st - cur_e, (cur_e + st) / 2))
                cur_s = st
            cur_e = max(cur_e, st + du)
        busy += min(cur_e, hi) - cur_s
        if hi > cur_e:
            gaps.append((hi - cur_e, (cur_e + hi) / 2))
        by_name: Dict[str, int] = {}
        by_family: Dict[str, int] = {}
        for name, _, du in ev:
            by_name[name] = by_name.get(name, 0) + du
            by_family[family(name)] = by_family.get(family(name), 0) + du
        gaps.sort(reverse=True)
        labelled = []
        for g, mid in gaps[:10]:
            label = spans.label_at((mid - offset) / 1e9) if spans is not None else None
            labelled.append([label or "no benchmark span open", g / 1e9])
        out = {
            "window_s": (hi - lo) / 1e9,
            "busy_s": busy / 1e9,
            "device_ops": [[n[:160], t / 1e9] for n, t in
                           sorted(by_name.items(), key=lambda x: -x[1])[:10]],
            "idle_gaps": labelled,
            "family_s": {k: v / 1e9 for k, v in by_family.items()},
            "profiler_cost_s": [self.start_cost_s, self.stop_cost_s],
            "host_from": self.t_begin, "host_to": self.t_stop + self.stop_cost_s,
            "markers": [len(side), len(main)],
        }
        if self.rec is not None:
            out["k1"] = self._match([e for e in ev if family(e[0]) == "K1"],
                                    self.rec.calls["K1"], 1, False)
            out["k3"] = self._match([e for e in ev if family(e[0]) == "K3"],
                                    self.rec.calls["K3"], 2, True)
        return out

    @staticmethod
    def _match(ev, calls, per_call, backward):
        """[(bound s, device s)] of the calls whose kernels all ran in the
        slice: the k-th call after the marker owns kernels k·per_call ..."""
        n = min(len(ev) // per_call, len(calls))
        res = []
        for i in range(n):
            dev = sum(du for _, _, du in ev[i * per_call:(i + 1) * per_call]) / 1e9
            res.append((_bound(calls[i], backward), dev))
        return res
