"""Compulsory bytes of one BFS: A read once as a CSR pattern (int32 row
pointers and column indices) and the level vector (int32) written
once; the sizes are the benchmark's own graph's."""


def compulsory_bytes(info: dict) -> int:
    n, nnz = int(info["n"]), int(info["nnz"])
    return 4 * (n + 1) + 4 * nnz + 4 * n
