"""The plain reference of the benchmark's cells: plain PyTorch and NumPy,
independent of the program under test (it imports nothing of it) and of
the JAX package, and computed from the inputs the harness makes."""
