"""The most device memory allocated at once in the window, in GiB
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``)."""


def read(observed):
    return observed.peak_device_bytes / (1 << 30)
