"""The most device memory allocated over set-up and window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(r):
    if r.trace is not None or r.peak_bytes <= 0:
        return None
    return r.peak_bytes / 2**30
