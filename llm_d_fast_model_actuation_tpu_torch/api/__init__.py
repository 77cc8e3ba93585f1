"""The port's copy of the parts of the JAX package's ``api/`` it uses."""
