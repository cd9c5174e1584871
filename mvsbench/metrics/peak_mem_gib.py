"""The card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes > 0 else None
