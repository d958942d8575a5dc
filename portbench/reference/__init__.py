"""Plain PyTorch references of what the benchmark times (float32, TF32
off).  Nothing here imports the program or JAX."""
