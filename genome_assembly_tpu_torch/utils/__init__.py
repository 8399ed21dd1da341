"""Utilities: JSONL metrics (``metrics``), trace capture and phase ranges
(``profiling``), counted-table and pointer-jump frontier checkpoints in the
JAX package's formats (``checkpoint``), and the verbose-output parsers and
validation plots (``plots``)."""
