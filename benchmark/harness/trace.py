"""A bounded device-trace sample of a run, read in memory (no file).

`DeviceTrace.sample()` wraps a stretch of the window in torch.profiler
(its CUDA activity alone: the device's operations and the host's CUDA
runtime calls, which cost the host far less than recording every
PyTorch operation too), synchronised at both ends. Its summary holds
the traced window's length on the host clock, the union of the device's
busy intervals (kernels, copies and fills), each device operation's
durations by name, and the longest idle gaps, each labelled by the
innermost CUDA runtime call open at its middle.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

TOP = 10
NAME_CHARS = 120


def _ns(e, what: str) -> int:
    """An event's start or duration in ns, across profiler versions."""
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    return int(getattr(e, f"{what}_us")() * 1000)


def _union(intervals: list) -> list:
    """Merged, sorted [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """The summary of every sample taken, added together."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.samples = 0
        self.kernels: dict = {}  # name -> [durations, s]
        self.gaps: list = []  # (seconds, label)
        self._prof = None
        self._t0 = 0.0
        self._pending: list = []

    @contextlib.contextmanager
    def sample(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def start(self) -> None:
        """Start a sample (the device synchronised first)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """End the sample once the device has finished its work; it is read
        by `finish`, after the window."""
        torch.cuda.synchronize()
        secs = time.perf_counter() - self._t0
        self._prof.stop()
        self._pending.append((self._prof, secs))
        self._prof = None

    def finish(self) -> None:
        """Read the samples taken."""
        for prof, secs in self._pending:
            self._add(prof.profiler.kineto_results.events(), secs)
        self._pending = []

    def _add(self, events, secs: float) -> None:
        device, host = [], []
        for e in events:
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((start, end, e.name()))
                self.kernels.setdefault(e.name(), []).append((end - start) / 1e9)
            elif end > start:
                host.append((start, end, e.name()))
        busy = _union([[s, e] for s, e, _n in device])
        self.busy_s += sum(e - s for s, e in busy) / 1e9
        self.window_s += secs
        self.samples += 1
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                      reverse=True)[:TOP]
        host.sort()
        for length, s, e in gaps:
            self.gaps.append((length / 1e9, self._label(host, (s + e) // 2)))
        self.gaps = sorted(self.gaps, reverse=True)[:TOP]

    @staticmethod
    def _label(host: list, t: int) -> str:
        """The innermost CUDA call open at time t (the latest started); where
        none is, the host's own work after the last call that ended."""
        best: Optional[tuple] = None
        last = None
        for s, e, name in host:
            if s > t:
                break
            if e >= t and (best is None or s >= best[0]):
                best = (s, name)
            elif e < t:
                last = name
        if best:
            return best[1][:NAME_CHARS]
        return f"host work after {last}"[:NAME_CHARS] if last else "host work"

    def kernel_mean_s(self, match) -> Optional[float]:
        """Mean duration of the device operations whose name `match(name)`
        accepts, or None where the sample holds none."""
        durs = [d for name, ds in self.kernels.items() if match(name) for d in ds]
        return sum(durs) / len(durs) if durs else None

    def breakdown(self) -> dict:
        ops = sorted(((sum(d), n) for n, d in self.kernels.items()), reverse=True)[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], s] for s, n in ops],
                "idle_gaps": [[label, s] for s, label in self.gaps]}

    def idle_pct(self, units: int, untraced_s: Optional[float]) -> Optional[float]:
        """The device's idle share of the untraced window: 1 - the sample's
        busy seconds a unit (a render, a step; `units` in the sample) over
        the untraced seconds a unit. The profiler's instrumentation
        stretches the sample's own window (a render's by ~1.6x), not the
        device's busy intervals, so the sample's busy / window would
        overstate idle."""
        if not untraced_s or self.busy_s <= 0 or units <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / units / untraced_s)
