"""The port's pure-Python byte-level BPE against the JAX package's, on the CPU.

The JAX package trains, saves, loads, encodes and decodes through
``tokenizers.ByteLevelBPETokenizer``; the port's ``data/tokenizer.py``
carries its own ``ByteLevelBPE``. On the same texts both must write
``vocab.json`` and ``merges.txt`` equal byte for byte, encode a corpus
to the same int32 stream, give the same fingerprint and decode any id
sequence (invalid UTF-8, unknown ids and special tokens included) to the
same text, trained or loaded from files. Texts come from the synthetic
corpus, this repository's Markdown and a seeded mix of hard characters
(accents, CJK, other-number digits, emoji, U+001C-U+001F, tabs, runs
of spaces, contractions).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from differential_transformer_replication_tpu.data import tokenizer as jtok
from differential_transformer_replication_tpu.data.corpus import (
    load_corpus as j_load_corpus,
)
from differential_transformer_replication_tpu_torch.data import tokenizer as ptok
from differential_transformer_replication_tpu_torch.data.corpus import (
    load_corpus,
    synthetic_corpus,
)

REPO = Path(__file__).resolve().parents[1]

# characters the pre-tokenizer classes must place as the Rust regex does
HARD = (list("abcXYZ019'.,!?-_\"\\/@#") + list("éüñçßÅøœ") + list("東京語中文")
        + list("ΑβγΩкиш") + list("١٢٣٤") + list("½²³⅓ⅷⅻ") + ["🙂", "😀", "👍", "🏽"]
        + ["\x1c", "\x1d", "\x1e", "\x1f", "\x85", "\xa0", "\u2002", "\u3000",
           "\u200b", "\ufeff", "\u2028"] + [" ", "  ", "   ", "\t", "\n", "\r\n"]
        + ["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", "''"])


def hard_texts(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(HARD, size=int(rng.integers(1, 40))))
            for _ in range(n)]


def markdown_lines() -> list:
    lines = []
    for path in sorted(REPO.glob("*.md")):
        lines += [ln.rstrip("\n") for ln in path.read_text(encoding="utf-8").splitlines()
                  if ln.strip()]
    return lines[:700]


def mixed_corpus(tmp_path: Path) -> list:
    """A text file of one document per line, read back as both packages'
    corpus loaders read it."""
    text = markdown_lines() + [
        "naïve café 東京 ½ ² 🙂\tx  y   z it's we'll they're I've I'm he'd",
        "a\x1cb \x1dc\x1e d\x1f e\x85f\xa0g　h i  \t j  ",
        "Ünïcödé ΑΒΓ δεζ Ωμέγα кириллица ١٢٣ ⅷ ⅻ 👍🏽 😀😀",
    ] * 3 + [t.replace("\n", " ").replace("\r", " ") for t in hard_texts(200, 5)]
    path = tmp_path / "mixed.txt"
    path.write_text("\n".join(text) + "\n", encoding="utf-8")
    got, want = load_corpus(str(path), 10**6), j_load_corpus(str(path), 10**6)
    assert got == want and len(got) > 700
    return got


CORPORA = {
    "synthetic200": lambda tmp: (synthetic_corpus(200), 12000, 2),
    "synthetic2000": lambda tmp: (synthetic_corpus(2000), 12000, 2),
    "mixed_file": lambda tmp: (mixed_corpus(tmp), 3000, 2),
    "mixed_file_min_frequency_1": lambda tmp: (mixed_corpus(tmp), 5000, 1),
    "vocab_below_alphabet": lambda tmp: (synthetic_corpus(200), 100, 2),
}


def _decode_ids(rng, n_vocab: int) -> list:
    """Id sequences for decode: random ids (single-byte tokens of
    0x80-0xFF make invalid UTF-8), ids past the vocabulary, the
    specials, and hand-made invalid sequences."""
    byte_id = {b: 2 + sorted(ptok.BYTE_ENCODER.values()).index(c)
               for b, c in ptok.BYTE_ENCODER.items()}
    seqs = [rng.integers(0, n_vocab + 5, size=int(rng.integers(1, 60))).tolist()
            for _ in range(40)]
    for raw in (b"\xe6\x9d", b"\xf0\x80\x80", b"\xff", b"\xc0\xaf",
                b"ab\xe6\x9d\xb1cd", b"\xed\xa0\x80", b"\xf4\x90\x80\x80",
                b"\xe2\x82", b"\x80\x80x", "東京🙂".encode()):
        seqs.append([byte_id[b] for b in raw])
    seqs.append([0, 1, 5, 0])
    return seqs


@pytest.mark.parametrize("case", sorted(CORPORA))
def test_bpe_files_ids_fingerprint_and_decode_equal_hf(case, tmp_path):
    texts, vocab_size, min_frequency = CORPORA[case](tmp_path)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jt = jtok.train_bpe_tokenizer(texts, vocab_size, min_frequency, str(jdir))
    pt = ptok.train_bpe_tokenizer(texts, vocab_size, min_frequency, str(pdir))
    for name in ("vocab.json", "merges.txt"):
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes(), name
    assert (pdir / "merges.txt").read_bytes().startswith(b"#version: 0.2\n")
    assert pt.get_vocab_size() == jt.get_vocab_size()
    if case == "vocab_below_alphabet":  # the specials and 256 bytes, no merge
        assert pt.get_vocab_size() == 258
        assert (pdir / "merges.txt").read_bytes() == b"#version: 0.2\n"
    got, want = ptok.encode_corpus(pt, texts), jtok.encode_corpus(jt, texts)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert ptok.tokenizer_fingerprint(pt) == jtok.tokenizer_fingerprint(jt)
    pl, jl = ptok.load_tokenizer(str(pdir)), jtok.load_tokenizer(str(jdir))
    assert ptok.tokenizer_fingerprint(pl) == jtok.tokenizer_fingerprint(jl)
    assert np.array_equal(ptok.encode_corpus(pl, texts), jtok.encode_corpus(jl, texts))
    rng = np.random.default_rng(len(texts))
    for ids in _decode_ids(rng, jt.get_vocab_size()):
        assert pt.decode(ids) == jt.decode(ids), ids  # trained: specials skipped
        assert pl.decode(ids) == jl.decode(ids), ids  # loaded: no specials
    assert ptok.vocab_strings(pl, pt.get_vocab_size() + 3) == \
        jtok.vocab_strings(jl, jt.get_vocab_size() + 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pretokenizer_splits_as_the_rust_byte_level_pre_tokenizer(seed):
    from tokenizers.pre_tokenizers import ByteLevel

    hf = ByteLevel(add_prefix_space=False)
    pat = ptok.pretokenizer()
    for text in hard_texts(300, seed):
        want = [piece for piece, _ in hf.pre_tokenize_str(text)]
        got = ["".join(ptok.BYTE_ENCODER[b] for b in piece.encode("utf-8"))
               for piece in pat.findall(text)]
        assert got == want, repr(text)


def test_white_space_is_unicode_white_space_not_isspace():
    """U+001C-U+001F are ``str.isspace()`` but not White_Space: a space
    before one joins it (` ?[^\\s\\p{L}\\p{N}]+`); before U+0085 and
    U+3000, which are White_Space, it does not."""
    pat = ptok.pretokenizer()
    for c in "\x1c\x1d\x1e\x1f":
        assert c.isspace()
        assert pat.findall(f"a {c}b") == ["a", f" {c}", "b"]
    for c in "\x85\u3000\xa0\u2028":
        assert pat.findall(f"a {c}b") == ["a", " ", c, "b"]
    # \p{N} is every number, not just decimal digits
    assert pat.findall("x ½²ⅷ") == ["x", " ½²ⅷ"]


def test_load_tokenizer_reads_hf_files_and_encodes_as_hf(tmp_path):
    texts = synthetic_corpus(300, seed=9) + markdown_lines()[:200]
    jtok.train_bpe_tokenizer(texts, 2000, 2, str(tmp_path))
    pl, jl = ptok.load_tokenizer(str(tmp_path)), jtok.load_tokenizer(str(tmp_path))
    probe = texts[:50] + hard_texts(50, 3) + ["Tom saw<|endoftext|> a cat<|pad|>"]
    for text in probe:  # a loaded tokenizer has no special tokens registered
        assert pl.encode(text).ids == jl.encode(text).ids, repr(text)
    assert [e.ids for e in pl.encode_batch(probe)] == \
        [e.ids for e in jl.encode_batch(probe)]
    assert pl.get_vocab() == jl.get_vocab()
    assert pl.token_to_id(ptok.EOT) == jl.token_to_id(jtok.EOT) == 0


def test_trained_tokenizer_maps_special_tokens_as_hf(tmp_path):
    texts = synthetic_corpus(200)
    pt = ptok.train_bpe_tokenizer(texts, 12000, 2, None)
    jt = jtok.train_bpe_tokenizer(texts, 12000, 2, None)
    for text in ("Tom saw<|endoftext|> a cat<|pad|>", "<|endoftext|>",
                 "<|pad|><|pad|>x<|endoftext|", "a <|endoftext|>  b"):
        assert pt.encode(text).ids == jt.encode(text).ids, text
    assert pt.encode("<|endoftext|>").ids == [0]


def test_fingerprint_refusal_message_equals_jax(tmp_path):
    """Same size, other content: the check refuses with JAX's message."""
    texts = synthetic_corpus(200)
    pt = ptok.train_bpe_tokenizer(texts, 12000, 2, str(tmp_path / "a"))
    other = ptok.train_bpe_tokenizer(synthetic_corpus(200, seed=5), 12000, 2,
                                     str(tmp_path / "b"))
    jother = jtok.load_tokenizer(str(tmp_path / "b"))
    fp = ptok.tokenizer_fingerprint(pt)
    with pytest.raises(SystemExit) as got:
        ptok.check_tokenizer_matches(other, other.get_vocab_size(), fp, "ckpt")
    with pytest.raises(SystemExit) as want:
        jtok.check_tokenizer_matches(jother, jother.get_vocab_size(), fp, "ckpt")
    assert str(got.value) == str(want.value) and "fingerprint" in str(got.value)
    with pytest.raises(SystemExit) as got:
        ptok.check_tokenizer_matches(pt, 12000, None, "ckpt")
    with pytest.raises(SystemExit) as want:
        jtok.check_tokenizer_matches(jtok.load_tokenizer(str(tmp_path / "a")),
                                     12000, None, "ckpt")
    assert str(got.value) == str(want.value)
    ptok.check_tokenizer_matches(pt, pt.get_vocab_size(), fp, "ckpt")  # passes
