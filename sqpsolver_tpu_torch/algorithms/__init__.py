"""algorithms of the PyTorch port."""
