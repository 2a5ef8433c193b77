"""Tensor ops of the port: the paged KV pool, paged attention, flash
attention and the dense flash decode (each with its Hopper kernel), and
the weight and int8 KV-row helpers the GPT paths share."""
