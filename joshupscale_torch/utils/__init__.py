"""Small helpers of the port (weight migration, display)."""
