"""The port's flow model families: ConvNeXt, MLP, MLP-Mixer, simple conv."""
