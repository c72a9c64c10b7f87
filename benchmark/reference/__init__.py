"""The benchmark's plain reference: its renderer, the tracking loss and its
pose gradient, and the trajectory error. Plain torch and numpy; nothing of
the port or of the JAX package is imported here."""
