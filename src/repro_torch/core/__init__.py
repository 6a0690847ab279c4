"""Partitioning, collectives, the ZeRO weight path and the training engine."""
