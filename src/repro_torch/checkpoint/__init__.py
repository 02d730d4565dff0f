"""Tree checkpoints of torch tensors and numpy arrays, readable by the JAX package."""
