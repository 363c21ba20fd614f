"""Image encoders of the port."""
