"""MPI-semantics API layer: communicators, groups, ops, errors."""
