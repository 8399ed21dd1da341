"""Utilities: the parsers of the verbose (print_kmer_read_ids) output."""
