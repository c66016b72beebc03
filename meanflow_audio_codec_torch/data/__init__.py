"""Training data: synthetic audio sources and the device replay pool."""
