"""Spectrogram classifiers: VGG16 and SmallCNN as ``torch.nn`` modules, the
Flax parameter carrier, host image loading and batched inference."""
