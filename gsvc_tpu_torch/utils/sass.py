"""The instruction mix of a kernel's inner loop, read from the SASS of a
built library (`cuobjdump -sass`): what the compiler made of the per-pair
arithmetic, counted per (pixel, lane) pair.

The inner loop of a kernel is the innermost loop (the range of a
backward branch that holds no other) with the most `MUFU.EX2`; each pair
evaluates one exponential, so a count over the loop divided by its
`MUFU.EX2` count is a count a pair. Counts are static: a gated branch
inside the loop counts in full, whether or not a pair takes it.
`EXPF` counts the range reduction of the accurate `expf` (its `FFMA.SAT`
and `FFMA.RM`); `__expf`, the fast-colour mode's, has none: one `FMUL` by
log2(e) before its `MUFU.EX2`.

`library_counts` counts each whole kernel's instructions by class, for
a kernel with no such loop (Adan's update: `chip_smoke.py` holds its
FFMA, FMUL and FADD to a build with `-fmad=false`).

    python -m gsvc_tpu_torch.utils.sass build/librasterize_fwd-<hash>.so

prints each kernel's loop mix; it needs `cuobjdump` (the CUDA toolkit's,
beside nvcc, or on PATH) and exits 1 without it.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from typing import Dict, List, Optional, Tuple

# opcode classes reported, by the mnemonic before its first '.'
CLASSES = ("LDS", "LDG", "FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "MUFU",
           "SHFL", "IMAD", "IADD3", "BRA")

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")
_NAME = re.compile(r"\d([A-Za-z_]+_kernel)I((?:L[ib]-?\d+E)+)E")
EXPF_REDUCTION = ("FFMA.SAT", "FFMA.RM")

Instr = Tuple[int, str, Optional[int]]  # address, opcode, branch target


def functions(text: str) -> Dict[str, List[Instr]]:
    """{mangled kernel name: [(address, opcode, branch target or None)]}
    of `cuobjdump -sass` output; a target is an address, labels resolved."""
    raw: Dict[str, list] = {}
    labels: Dict[str, Dict[str, int]] = {}
    cur = None
    pending: List[str] = []
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = m.group(1)
            raw[cur], labels[cur], pending = [], {}, []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[cur][lab] = addr
        pending = []
        tokens = m.group(2).split()
        if tokens and tokens[0].startswith("@"):
            tokens = tokens[1:]
        if not tokens:
            continue
        op = tokens[0]
        target = None
        if op.startswith("BRA"):
            t = _TARGET.search(m.group(2))
            if t:
                target = t.group(1) or int(t.group(2), 16)
        raw[cur].append((addr, op, target))
    return {name: [(a, op, labels[name].get(t) if isinstance(t, str) else t)
                   for a, op, t in ins] for name, ins in raw.items()}


def inner_loop(instrs: List[Instr]) -> Optional[List[Instr]]:
    """The instructions of the innermost loop with the most MUFU.EX2
    (None where no loop holds one)."""
    loops = sorted({(t, a) for a, op, t in instrs if t is not None and t <= a})
    best, best_key = None, None
    for lo, hi in loops:
        if any((lo <= l2 and h2 <= hi) and (l2, h2) != (lo, hi) for l2, h2 in loops):
            continue  # holds another loop
        body = [i for i in instrs if lo <= i[0] <= hi]
        key = (sum(op == "MUFU.EX2" for _a, op, _t in body), len(body))
        if key[0] > 0 and (best_key is None or key > best_key):
            best, best_key = body, key
    return best


def loop_mix(instrs: List[Instr]) -> Optional[dict]:
    """{"instructions", "pairs", "per_pair": {class: count a pair}} of a
    kernel's inner loop, None where it has none."""
    body = inner_loop(instrs)
    if body is None:
        return None
    counts = Counter(op.split(".")[0] for _a, op, _t in body)
    pairs = sum(op == "MUFU.EX2" for _a, op, _t in body)
    per_pair = {c: counts[c] / pairs for c in CLASSES}
    per_pair["EXPF"] = sum(op.startswith(EXPF_REDUCTION) for _a, op, _t in body) / pairs
    per_pair["all"] = len(body) / pairs
    return {"instructions": len(body), "pairs": pairs, "per_pair": per_pair}


def pretty(name: str) -> str:
    """`forward_kernel<2,0>` for a mangled template kernel name (a bool
    argument as 0 or 1)."""
    m = _NAME.search(name)
    if not m:
        return name
    return f"{m.group(1)}<{','.join(re.findall(r'L[ib](-?\d+)E', m.group(2)))}>"


def cuobjdump() -> Optional[str]:
    """The toolkit's cuobjdump (beside nvcc, or on PATH), None if absent."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "cuobjdump"), shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    return None


def _sass(lib_path) -> Optional[Dict[str, List[Instr]]]:
    """`functions` of a built library's SASS; None where there is no
    cuobjdump."""
    tool = cuobjdump()
    if tool is None:
        return None
    return functions(subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                                    text=True, check=True, timeout=300).stdout)


def library_mix(lib_path) -> Optional[Dict[str, dict]]:
    """{kernel: loop_mix} of every kernel in a built library that has an
    inner loop; None where there is no cuobjdump."""
    funcs = _sass(lib_path)
    if funcs is None:
        return None
    out = {}
    for name, instrs in funcs.items():
        mix = loop_mix(instrs)
        if mix is not None:
            out[pretty(name)] = mix
    return out


def library_counts(lib_path) -> Optional[Dict[str, Counter]]:
    """{kernel: its instructions counted by class (the mnemonic before its
    first '.')} over each whole function of a built library; None where
    there is no cuobjdump."""
    funcs = _sass(lib_path)
    if funcs is None:
        return None
    return {pretty(name): Counter(op.split(".")[0] for _a, op, _t in instrs)
            for name, instrs in funcs.items()}


def describe(kernel: str, mix: dict) -> str:
    per = mix["per_pair"]
    return (f"{kernel}: loop of {mix['instructions']} instructions, {mix['pairs']} pairs; "
            "a pair " + " ".join(f"{c} {per[c]:.2f}" for c in (*CLASSES, "EXPF", "all")
                                   if per[c] > 0))


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if cuobjdump() is None:
        print("sass: no cuobjdump: the instruction mix is not measured", file=sys.stderr)
        return 1
    for path in paths:
        for kernel, mix in sorted(library_mix(path).items()):
            print(f"{os.path.basename(path)} {describe(kernel, mix)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
