"""Training data: audio sources and loaders, MNIST, the device replay pool."""
