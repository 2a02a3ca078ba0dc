"""Compulsory bytes of one ``bfs5m`` call: those of one ``bfs_csr``
call on the same graph (A read once as a CSR pattern, the levels
written once), so that ``call_roofline`` counts the same work whatever
implements the BFS; the by-column twin the call makes is its own cost,
not compulsory."""

from .bfs_csr import compulsory_bytes

__all__ = ["compulsory_bytes"]
