"""Device-side compute ops: codecs, the canonical scan, counting, the dBG."""
