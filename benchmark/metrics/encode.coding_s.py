"""Host seconds a frame spends measuring and writing its bits: the host
seconds of the window's `qat.bits` (`measure_bits`: the eval render and
the host rANS of the codes) and `qat.encode` (`encode_frame`: the codes
quantised and entropy-coded again into the frame's bytes) spans, over
the window's frames (one `qat.encode` a frame). `harness/program_spans.py`
says how the window's spans are told apart."""

from benchmark.harness import program_spans


def read(run):
    spans = program_spans.window(run)
    full = run.config["qat_iterations"]
    coded = [s for s in spans or [] if s.name in ("qat.bits", "qat.encode")
             and s.attrs and s.attrs.get("iterations") == full]
    frames = sum(1 for s in coded if s.name == "qat.encode")
    if not frames:
        return None
    return sum(s.host_s for s in coded) / frames
