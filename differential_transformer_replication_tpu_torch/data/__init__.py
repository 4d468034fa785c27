"""Data of the port: the corpus (data/corpus.py), the pure-Python
byte-level BPE tokenizer and corpus encoding (data/tokenizer.py), the
token-stream window sampler (data/sampler.py) and the epoch sampler's
permutation (data/native.py). The trainer's ``build_data`` joins them
(train/trainer.py)."""

from differential_transformer_replication_tpu_torch.data.corpus import load_corpus
from differential_transformer_replication_tpu_torch.data.sampler import (
    TokenWindows,
    split_tokens,
)
from differential_transformer_replication_tpu_torch.data.tokenizer import (
    encode_corpus,
    load_tokenizer,
    train_bpe_tokenizer,
)

__all__ = [
    "load_corpus",
    "train_bpe_tokenizer",
    "load_tokenizer",
    "encode_corpus",
    "TokenWindows",
    "split_tokens",
]
