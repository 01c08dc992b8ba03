"""Primitive models: analytic spheres and triangle lists."""
