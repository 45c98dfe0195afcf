"""Training for the synthesis stack and the style embedder: the port of the
JAX package's ``train/``."""
