"""Service handler and command-line interface of the PyTorch pipeline."""
