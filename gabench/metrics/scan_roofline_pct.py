"""K1's share of its roofline: the least time its launches in the window
could take, each moving ``roofline.scan_bytes`` at the card's peak bandwidth,
over their summed time on the device.  Every launch of the fast path scans
one batch of ``batch_reads`` rows padded to ``max_read_len``."""

from gabench import roofline

KERNEL = "fast_scan_kernel"


def read(observed):
    if observed.trace is None:
        return None
    launches, seconds = observed.trace.kernel_seconds(KERNEL)
    if not launches:
        return None
    p = observed.config["pipeline"]
    bound_s = launches * roofline.scan_bytes(p["batch_reads"], p["max_read_len"], p["k"]) / (
        roofline.PEAK_BYTES_PER_S)
    return 100.0 * bound_s / seconds
