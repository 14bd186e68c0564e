"""Weight carry-over and package loading."""
