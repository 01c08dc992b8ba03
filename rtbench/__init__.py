"""The port's benchmark: cells of BENCHMARK.json run by `python3 -m
rtbench.run`, held to the plain reference in rtbench/reference/.

Imports nothing of the JAX package and, on the reference's side,
nothing of the port.
"""
