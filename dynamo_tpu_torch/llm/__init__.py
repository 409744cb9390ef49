"""LLM serving layer: protocols, tokenizer, preprocessing, detokenizing
backend, KV block pool, the PyTorch engine adapter and the HTTP frontend."""
