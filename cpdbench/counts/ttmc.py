"""Work of one TTMc call (the chain-of-modes product of Tucker's HOOI),
counted from the COO tensor and the dense operands, whatever layout or
kernel computes it.

Bytes: each non-zero once (an int32 index a mode and a 4-byte value), the
other modes' factors once, the (I_n, W) output once, W the product of the
other modes' ranks.  Operations: per non-zero, the value times the first
other row (R operations), the Kronecker row of the other rows (W for an
order-3 tensor; the partial products for a longer chain), and the add of
the row into the output (W).
"""

WORD = 4


def call(dims, nnz: int, ranks, mode: int) -> tuple[float, float]:
    """``(bytes, operations)`` of the mode-``mode`` TTMc."""
    order = len(dims)
    others = [m for m in range(order) if m != mode]
    width = 1
    for m in others:
        width *= int(ranks[m])
    nbytes = nnz * (order + 1) * WORD
    nbytes += sum(int(dims[m]) * int(ranks[m]) * WORD for m in others)
    nbytes += int(dims[mode]) * width * WORD
    per_entry = int(ranks[others[0]])
    partial = int(ranks[others[0]])
    for m in others[1:]:
        partial *= int(ranks[m])
        per_entry += partial
    per_entry += width
    return float(nbytes), float(nnz) * per_entry
