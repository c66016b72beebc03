"""The ConvNeXt flow model family of the port."""
