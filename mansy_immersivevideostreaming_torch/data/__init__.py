"""Dataset IO (numpy only)."""
