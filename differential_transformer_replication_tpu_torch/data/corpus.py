"""Corpus loading: a copy of ``differential_transformer_replication_tpu/
data/corpus.py`` (same names, sources and fallback). The source is a
config switch:
  - ``"tinystories"``: the HF dataset through ``datasets.load_dataset``,
    imported lazily inside a ``try``: any failure (no ``datasets``
    package, no local cache, no network) falls back to synthetic,
  - ``"synthetic"``: a seeded generator of TinyStories-like text so the
    full pipeline runs hermetically,
  - a filesystem path: plain text, one document per line.

Falls back from tinystories to synthetic with a warning rather than
failing, so training is always runnable.
"""

from __future__ import annotations

import os
import sys
from typing import List

_SYNTH_NOUNS = [
    "cat", "dog", "bird", "tree", "ball", "house", "river", "star", "frog",
    "bear", "boat", "cake", "hat", "moon", "sun", "fish", "girl", "boy",
    "dragon", "garden", "mouse", "cloud", "flower", "stone", "fox", "owl",
]
_SYNTH_NAMES = [
    "Tom", "Lily", "Max", "Mia", "Sam", "Anna", "Ben", "Sue", "Tim", "Amy",
    "Leo", "Zoe", "Jack", "Emma", "Finn", "Ruby",
]
_SYNTH_VERBS = [
    "found", "saw", "liked", "chased", "made", "lost", "painted", "carried",
    "hugged", "shared", "hid", "threw", "caught", "visited", "built",
]
_SYNTH_ADJS = [
    "big", "small", "red", "happy", "sad", "shiny", "old", "funny", "brave",
    "tiny", "green", "soft", "loud", "quiet", "kind",
]


def synthetic_corpus(num_docs: int, seed: int = 1337) -> List[str]:
    """Seeded TinyStories-like documents: short simple sentences with a
    tiny vocabulary, enough structure for a small LM to learn from.

    All randomness is drawn in a handful of vectorized numpy calls — the
    original per-sentence ``rng.choice`` loop cost minutes at the
    reference's 1M-document scale (~10M generator calls) and dominated
    pipeline startup."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_sent = rng.integers(2, 6, size=num_docs)
    total = int(n_sent.sum())
    doc_names = rng.choice(_SYNTH_NAMES, size=num_docs)
    nouns = rng.choice(_SYNTH_NOUNS, size=total)
    verbs = rng.choice(_SYNTH_VERBS, size=total)
    adjs = rng.choice(_SYNTH_ADJS, size=total)
    forms = rng.integers(0, 4, size=total)
    others = rng.choice(_SYNTH_NAMES, size=total)

    docs = []
    s = 0
    for i in range(num_docs):
        name = doc_names[i]
        sents = []
        for j in range(s, s + int(n_sent[i])):
            f = forms[j]
            if f == 0:
                sents.append(f"{name} {verbs[j]} a {adjs[j]} {nouns[j]}.")
            elif f == 1:
                sents.append(f"One day, {name} {verbs[j]} the {nouns[j]}.")
            elif f == 2:
                sents.append(f"The {nouns[j]} was very {adjs[j]}.")
            else:
                sents.append(
                    f"{name} and {others[j]} {verbs[j]} a {nouns[j]} together."
                )
        s += int(n_sent[i])
        docs.append(" ".join(sents))
    return docs


def load_corpus(dataset: str, num_train_samples: int, seed: int = 1337) -> List[str]:
    """Returns the first ``num_train_samples`` documents (train.py:165)."""
    return load_corpus_resolved(dataset, num_train_samples, seed)[0]


def load_corpus_resolved(
    dataset: str, num_train_samples: int, seed: int = 1337
) -> tuple:
    """Like ``load_corpus``, but also returns the name of the source
    actually used — callers that cache derived artifacts must key on this,
    not the requested name, or the tinystories->synthetic fallback would
    poison the cache for later online runs."""
    if dataset == "synthetic":
        return synthetic_corpus(num_train_samples, seed), "synthetic"
    if dataset == "tinystories":
        try:
            from datasets import load_dataset

            ds = load_dataset("roneneldan/TinyStories")
            return list(ds["train"]["text"][:num_train_samples]), "tinystories"
        except Exception as e:  # no cache / no network
            print(
                f"[data] TinyStories unavailable ({type(e).__name__}); "
                "falling back to the synthetic corpus",
                file=sys.stderr,
            )
            return synthetic_corpus(num_train_samples, seed), "synthetic"
    if os.path.exists(dataset):
        with open(dataset, "r", encoding="utf-8") as f:
            texts = [line.rstrip("\n") for line in f if line.strip()]
        return texts[:num_train_samples], dataset
    raise ValueError(f"unknown dataset {dataset!r} (not a known name or a path)")
