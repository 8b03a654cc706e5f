"""Streaming simulator and ABR environment."""
