"""Compulsory bytes of one triangle count: L and U as CSR patterns
(int32 row pointers and column indices, each read once; the count reads
no value) and the count written once (8 bytes).  L and U each hold the
graph's m undirected edges, counted by the reference from the
benchmark's own triplets, never from a plan of the port."""


def compulsory_bytes(info: dict) -> int:
    n, m = int(info["n"]), int(info["m"])
    return 2 * (4 * (n + 1) + 4 * m) + 8
