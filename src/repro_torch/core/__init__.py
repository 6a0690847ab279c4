"""Degree-1 partitioning, collectives and the fused-matmul weight path."""
