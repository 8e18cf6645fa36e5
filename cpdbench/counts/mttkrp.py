"""Work of one MTTKRP call, counted from the COO tensor and the dense
operands, whatever layout or kernel computes it: so every implementation
of the same call is read against the same least time.

Bytes: each non-zero once (an int32 index a mode and a 4-byte value), the
other modes' factors once, the output once.  Operations: per non-zero and
column, the value times the other modes' rows and the add into the output,
``order`` operations.
"""

WORD = 4


def call(dims, nnz: int, ranks, mode: int) -> tuple[float, float]:
    """``(bytes, operations)`` of the mode-``mode`` MTTKRP."""
    order = len(dims)
    rank = int(ranks[mode])
    nbytes = nnz * (order + 1) * WORD
    nbytes += sum(int(d) * rank * WORD for m, d in enumerate(dims)
                  if m != mode)
    nbytes += int(dims[mode]) * rank * WORD
    return float(nbytes), float(nnz) * rank * order
