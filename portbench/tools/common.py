"""What the tools share: the card's line, the cell with changed traffic,
and one JSON line per result to standard output and to a file."""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def with_traffic(cell, **params):
    out = copy.deepcopy(cell)
    out.traffic.update(params)
    return out


class Log:
    """Appends JSON lines to ``path`` and echoes them."""

    def __init__(self, path: str | None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def __call__(self, **row) -> None:
        row.setdefault("t", time.strftime("%H:%M:%S"))
        text = json.dumps(row)
        print(text, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(text + "\n")
