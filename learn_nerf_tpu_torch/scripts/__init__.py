"""Command-line entry points (vanilla NeRF render and serve)."""
