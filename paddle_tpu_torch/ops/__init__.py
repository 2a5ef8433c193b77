"""Tensor ops of the port: the paged KV pool, paged attention (with its
Hopper kernel) and the raw-weight helpers the GPT serving path shares."""
