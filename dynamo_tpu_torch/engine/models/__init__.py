"""Model families of the PyTorch engine (dense llama)."""
