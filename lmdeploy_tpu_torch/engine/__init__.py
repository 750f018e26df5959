"""Engine: continuous-batching loop, model agent, KV cache, decode state."""
