"""Command-line tools of the port (profiling on the card)."""
