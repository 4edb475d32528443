"""Command-line entry points of the port (``serve`` so far)."""
