"""Counting core: patterns, quotients, decompositions, contraction engine."""
