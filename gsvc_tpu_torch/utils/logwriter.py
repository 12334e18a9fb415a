"""Append-to-file logger (PyTorch port of gsvc_tpu/utils/logwriter.py,
the reference `LogWriter`, utils.py:10-18).

Keeps the exact train.txt lines of both drivers: result-parsing tools and
the decoder's PSNR check read them.
"""

from __future__ import annotations

import os


class LogWriter:
    def __init__(self, file_path, train: bool = True, suffix: str = ""):
        """suffix: per-host shard tag of a multi-host run (e.g. ".host0")."""
        os.makedirs(file_path, exist_ok=True)
        name = ("train" if train else "test") + suffix + ".txt"
        self.file_path = os.path.join(str(file_path), name)

    def write(self, text: str) -> None:
        print(text)
        with open(self.file_path, "a") as f:
            f.write(text + "\n")
