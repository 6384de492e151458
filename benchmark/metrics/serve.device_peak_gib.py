"""Peak device memory allocated over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(rec):
    return rec["window_peak_bytes"] / 2**30
