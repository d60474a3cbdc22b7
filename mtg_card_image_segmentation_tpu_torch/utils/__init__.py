"""Device resolution and the weight bridge from the JAX package's trees."""
