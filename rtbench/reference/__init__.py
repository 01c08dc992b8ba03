"""The plain reference the benchmark holds the program's images to.

Plain PyTorch and NumPy, written from the reference rust project's
semantics and the program's stated behaviour. It imports nothing of the
program and takes nothing the program made: it builds its triangles,
planes, texture, cameras and random draws again from the benchmark's own
inputs.
"""
