"""The plain reference the benchmark holds the program's answers to.

NumPy and plain PyTorch only: nothing here imports jax, the JAX package or
the program (tpurag_torch), and nothing takes what the program made. It
rebuilds the BM25 statistics from the generated texts and the exact dense
scores from the generated vectors.
"""
