"""Service handler, HTTP service (/process, /classify and its batcher),
dashboard and command-line interface of the PyTorch pipeline."""
