"""Tensor ops of the port: the paged KV pool, paged attention, flash
attention (forward and backward) and the dense flash decode (each with its
Hopper kernel), the blockwise LM-head loss, and the weight and int8 KV-row
helpers the GPT paths share."""
