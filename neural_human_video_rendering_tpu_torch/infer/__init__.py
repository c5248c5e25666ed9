"""infer layer of the PyTorch port."""
