"""JAX params bridge and random init."""
