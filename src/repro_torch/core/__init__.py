"""Control plane (Amber), Reshape and Maestro objectives: copies of the
JAX-free ``repro.core`` modules the serving and training slices run."""
