"""Data of the port: the token-stream window sampler (data/sampler.py).
The corpus, BPE tokenizer and epoch sampler are a later slice."""
