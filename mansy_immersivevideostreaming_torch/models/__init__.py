"""Policy networks."""
