"""Compulsory bytes of one masked product C<M> = L·U: M, L and U each
read once as CSR (int32 row pointers and column indices, 4-byte values)
and C written once in the same form.  The sizes are the benchmark's own
operands' and the reference's C, never a plan or a panel of the port."""


def compulsory_bytes(info: dict) -> int:
    row_ptrs = 4 * (int(info["n"]) + 1)
    entries = sum(info["nnz"].values()) + int(info["nnz_C"])
    return 4 * row_ptrs + 8 * entries
