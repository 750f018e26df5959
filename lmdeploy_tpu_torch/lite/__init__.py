"""Offline quantization formats (the AWQ / GPTQ checkpoint layouts)."""
