"""Plain reference of the ``bfs5m`` entry: BFS levels (1 = the source,
0 = unreached) from row to column, which are the same whichever path
computes them, so the ``bfs_csr`` reference serves: its ``levels``, its
limits (every level exact) and its int8 control.  It imports nothing of
the port."""

from .bfs_csr import LIMITS, control, control_numbers, levels

__all__ = ["LIMITS", "control", "control_numbers", "levels"]
