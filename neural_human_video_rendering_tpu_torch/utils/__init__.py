"""utils layer of the PyTorch port."""
