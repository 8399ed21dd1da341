"""Parity mode: exact replication of the reference binary's behaviour --
the executable spec, the host tables, the replay and the non-ACGT path."""
