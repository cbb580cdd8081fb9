"""Bits per int of the blobs the set-up wrote, one an array of the pool:
8 * their bytes / (pool * n) (every cell).  What users pay for storage."""


def read(run):
    return run.blob_bits / (run.pool * run.n)
