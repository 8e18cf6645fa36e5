"""peak_gb: the most device memory the program held, in 1e9 bytes, from
the end of the input's generation to the end of the window
(``torch.cuda.max_memory_allocated``)."""


def read(rec):
    peak = rec.get("peak_bytes")
    return peak / 1e9 if peak else None
