"""Transforms, tokenizer, embeddings and sampler of the port, with the CUDA kernel wrappers."""
