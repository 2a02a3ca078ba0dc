"""Compulsory bytes of one MIS call: A read once as a CSR pattern
(int32 row pointers and column indices) and the set written once (a
byte a vertex); the sizes are the benchmark's own graph's.  The scores,
the candidates and the by-column twin the call makes are its own cost,
not compulsory."""


def compulsory_bytes(info: dict) -> int:
    n, nnz = int(info["n"]), int(info["nnz"])
    return 4 * (n + 1) + 4 * nnz + n
