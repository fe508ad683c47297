"""The benchmark's yardstick: the seeded data, the exact answers and the
comparison that decides ``correct``.  Plain PyTorch and NumPy only: nothing
here imports the port, JAX or the JAX package."""
