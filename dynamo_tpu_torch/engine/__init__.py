"""Model-executing engine: config, attention kernels, llama model, sampler,
weights and the continuous-batching core."""
