"""setup_s: seconds from the start of the process to the first measured
fit: CUDA's start, the input's generation, ingest and the Sort, and the
warm-up fit (which builds the kernels in a fresh checkout)."""


def read(rec):
    return rec.get("setup_s")
