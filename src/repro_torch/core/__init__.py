"""Control plane (Amber), Maestro objectives: copies of the JAX-free
``repro.core`` modules the serving slice runs."""
