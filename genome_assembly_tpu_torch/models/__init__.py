"""Pipeline-level models: the fast assembly engine."""
