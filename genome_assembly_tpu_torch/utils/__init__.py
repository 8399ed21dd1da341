"""Utilities: the parsers of the verbose (print_kmer_read_ids) output, and
the pointer-jump frontier checkpoints."""
