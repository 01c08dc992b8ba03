"""Primitive models: analytic spheres, triangle lists and the single
triangle (dead code in the reference, kept for API completeness)."""
