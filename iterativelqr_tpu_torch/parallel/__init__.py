"""Batched solves."""

from .batch import BatchStats, batch_stats, make_batched_solve_fn

__all__ = ["BatchStats", "batch_stats", "make_batched_solve_fn"]
