"""Plain references the benchmark holds the program's outputs against.

They import neither JAX nor any SAFE package: only torch and numpy, and
nothing the program has made.
"""
