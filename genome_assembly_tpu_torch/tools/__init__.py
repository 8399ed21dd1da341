"""Tools of the port: the genome-scale runner (``run_scale``)."""
