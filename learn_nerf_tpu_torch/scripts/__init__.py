"""Command-line entry points (render and serve, vanilla NeRF and Instant-NGP)."""
