"""The device mesh and sequence-parallel (ring-attention) prefill."""
