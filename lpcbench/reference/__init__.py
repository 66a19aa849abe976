"""The plain reference that decides a run's `correct`: plain PyTorch,
independent of the port (lpcnet_tpu_torch) and of JAX. It reads the same
raw input files as the benchmark hands the program, and works out again
everything the program derives from them."""
