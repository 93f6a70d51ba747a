"""Text front end: the port's own copies of the JAX package's JAX-free
tokenizer and preprocessing modules."""
