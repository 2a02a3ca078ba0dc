"""The table of published peaks (``peaks.json``, by the name
``torch.cuda.get_device_name`` gives) and the card's power limit."""

from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path

import torch

TABLE = json.loads((Path(__file__).resolve().parent
                    / "peaks.json").read_text())


def memory_rate(kind: str):
    """The published memory rate of the card ``kind`` in bytes/s, or
    None for a card the table does not hold."""
    entry = TABLE.get(kind)
    return None if entry is None else float(entry["memory_bytes_per_s"])


def power_limit_w(index: int = 0):
    """``nvidia-smi``'s power.limit of card ``index`` in watts, or None
    where it cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        res = subprocess.run(
            [smi, f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def card(device) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        return {"kind": "cpu", "memory_bytes_per_s": None,
                "power_limit_w": None}
    kind = torch.cuda.get_device_name(device)
    return {"kind": kind, "memory_bytes_per_s": memory_rate(kind),
            "power_limit_w": power_limit_w(device.index or 0)}
