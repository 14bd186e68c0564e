"""Models of the serving path and their registry."""
