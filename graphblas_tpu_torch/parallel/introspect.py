"""The collective census of the distributed layer.

Counterpart of ``graphblas_tpu/parallel/introspect.py``.  The JAX
package compiles each distributed call into one SPMD program and reads
its schedule out of the compiled HLO (``hlo_collectives``: collective
instructions and payload bytes per execution) and XLA's memory analysis.
Here the collectives run eagerly, one call at a time, so there is no
HLO and ``hlo_collectives`` has no counterpart: the census is taken as
the collectives run.  Every collective of :mod:`.comm` notes its kind,
its payload bytes (what this rank puts in) and whether it was staged
through host memory into the record of each distributed call in
progress; a call's record replaces the previous call's of the same name.

:func:`program_stats` gives, for the last call of a name, ``collectives``
(per kind: ``calls``, ``bytes``, ``staged_calls``, ``staged_bytes``)
and ``device_memory``: ``shard_bytes``, the bytes of the call's
operands on this rank, and on the card ``peak_allocated_bytes``,
``torch.cuda.max_memory_allocated`` at the call's end (the peak since
the caller last reset it).  The counts are this rank's; a ring rotation
is one ``ppermute`` call per array sent.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from ..utils.tree import tree_leaves

__all__ = ["enable", "record", "last", "program_stats", "note"]

_LAST: Dict[str, dict] = {}
_ACTIVE: List[dict] = []
_ENABLED = True


def enable(on: bool = True) -> None:
    """Turn the census on (the default) or off; off also forgets the
    records.  It holds counters only, never the operands."""
    global _ENABLED
    _ENABLED = on
    if not on:
        _LAST.clear()


def _tensors(shards) -> list:
    return [t for s in shards for t in tree_leaves(s)
            if isinstance(t, torch.Tensor)]


@contextlib.contextmanager
def record(name: str, *shards):
    """Census one distributed call: the collectives run inside the
    ``with`` block are counted under ``name`` (and under every enclosing
    call's name); ``shards`` are the call's operand tensors on this
    rank."""
    if not _ENABLED:
        yield None
        return
    tensors = _tensors(shards)
    rec = {"collectives": {},
           "shard_bytes": sum(t.numel() * t.element_size()
                              for t in tensors)}
    dev = tensors[0].device if tensors else None
    _LAST[name] = rec
    _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        _ACTIVE.remove(rec)
        if dev is not None and dev.type == "cuda":
            rec["peak_allocated_bytes"] = int(
                torch.cuda.max_memory_allocated(dev))


def note(kind: str, nbytes: int, staged: bool) -> None:
    """Count one collective of ``kind`` carrying ``nbytes`` from this
    rank in every call in progress."""
    for rec in _ACTIVE:
        c = rec["collectives"].setdefault(kind, {
            "calls": 0, "bytes": 0, "staged_calls": 0, "staged_bytes": 0})
        c["calls"] += 1
        c["bytes"] += int(nbytes)
        if staged:
            c["staged_calls"] += 1
            c["staged_bytes"] += int(nbytes)


def last(name: str) -> Optional[dict]:
    """The raw record of the last ``name`` call (None if none)."""
    return _LAST.get(name)


def program_stats(name: str) -> Optional[dict]:
    """The census of the last ``name`` call on this rank: collectives
    per kind and device memory (see the module docstring)."""
    rec = _LAST.get(name)
    if rec is None:
        return None
    mem = {"shard_bytes": rec["shard_bytes"]}
    if "peak_allocated_bytes" in rec:
        mem["peak_allocated_bytes"] = rec["peak_allocated_bytes"]
    return {"collectives": {k: dict(v)
                            for k, v in rec["collectives"].items()},
            "device_memory": mem}
