"""Weight conversion between the JAX package's variables and the port."""
