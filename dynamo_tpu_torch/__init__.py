"""PyTorch/CUDA port of the dynamo-tpu serving system.

Serves OpenAI completions from a llama-family model on one NVIDIA GPU
(H100), with hand-written CUDA kernels for prefill and paged decode
attention (``csrc/``). It mirrors the layout of the JAX package
``dynamo_tpu`` module by module and imports nothing of it: ``torch``,
``numpy`` and the standard library only.
"""
