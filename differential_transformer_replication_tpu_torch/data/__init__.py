"""Data of the port: the token-stream window sampler (data/sampler.py)
and the epoch sampler's permutation (data/native.py). The corpus and
BPE tokenizer are a later slice."""
