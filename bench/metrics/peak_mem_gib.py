"""The card's peak of allocated memory over the window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
