"""The program's own spans of an encode run's window, for the readers of
`encode.replay_ms`, `encode.eager_s`, `encode.capture_s` and
`encode.coding_s`.

The port records spans into one process-wide recorder
(`gsvc_tpu_torch.utils.profiling.RECORDER`): a `fit` span for every fit
(attributes kind, first and last step, the config's iterations) holding
its `fit.eager`, `fit.warmup`, `graph.capture`, `fit.replays` and
`fit.sync` spans, and a `qat.bits` and a `qat.encode` span for every
coded frame. A reader tells the run's own spans apart so:

- the window: the window's frames (`run.counters["frames"]`) each end
  with one `qat.encode` span, and nothing of the program runs between
  the window's end and the readers. So the window's spans are those
  opened after the end of the `qat.encode` span that came before the
  window's last `frames` ones: set-up's frames and any earlier run in
  the process lie before it;
- whole fits: a window's fit whose steps ran from 1 to the config's full
  count (`iterations`, `qat_iterations`). Set-up's warm-up fits (8 and 5
  steps) are shorter, and the checked frames run theirs as slices (step
  1, steps 2 to `check_steps`, the rest), none of which runs from 1 to
  the end;
- fits to the end: a window's fit whose last step is the config's full
  count, whatever its first: the whole fits, and the last slice of each
  checked frame (steps `check_steps` + 1 to the end) and of the traced
  frame (steps `trace_steps[1]` + 1 to the end). These run no step under
  the profiler, whose slice ends at `trace_steps[1]`; set-up's fits end
  before the full count.

Everything returns None where the program has no recorder (a tree
before it) or the run holds no such span.
"""

from __future__ import annotations

from typing import Optional


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from gsvc_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "RECORDER", None)


def window(run) -> Optional[list]:
    """The spans of the run's window, in the order they closed."""
    rec = recorder()
    frames = run.counters.get("frames")
    if rec is None or not frames:
        return None
    spans = rec.spans()
    encodes = [s for s in spans if s.name == "qat.encode"]
    if len(encodes) < frames:
        return None
    after = encodes[-frames - 1].t1 if len(encodes) > frames else None
    return [s for s in spans if after is None or s.t0 >= after]


def fits_to_end(spans: list, kind: str, iterations: int) -> list:
    """The `fit` spans of `kind` whose last step was `iterations`."""
    return [s for s in spans if s.name == "fit" and s.attrs
            and s.attrs.get("kind") == kind and s.attrs.get("last") == iterations]


def whole_fits(spans: list, kind: str, iterations: int) -> list:
    """The `fit` spans of `kind` that ran from step 1 to `iterations`."""
    return [s for s in fits_to_end(spans, kind, iterations) if s.attrs.get("first") == 1]


def children(spans: list, parents: list, names: tuple) -> list:
    """The spans named in `names` directly inside one of `parents`."""
    ids = {p.id for p in parents}
    return [s for s in spans if s.parent in ids and s.name in names]
