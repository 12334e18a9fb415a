"""The benchmark's own tests: faults of the loops that share another
loop's code. `encode_uhd` is `encode`'s loop with the blocked reference,
so it has `encode`'s faults (`harness/faults.py` keys them by loop)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import faults  # noqa: E402

for _table in (faults.BY_LOOP, faults.CARD_ONLY):
    _table.setdefault("encode_uhd", _table["encode"])
