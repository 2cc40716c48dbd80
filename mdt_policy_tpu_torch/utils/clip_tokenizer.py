"""CLIP byte-pair tokenizer (a copy of `mdt_policy_tpu/utils/clip_tokenizer.py`
that needs only numpy and the standard library).

Produces the token ids the CLIP text tower expects (vocab 49408, context 77,
<|startoftext|>/<|endoftext|> wrapping), from the published BPE algorithm:

* GPT-2 byte<->unicode table,
* merges loaded from the standard `bpe_simple_vocab_16e6.txt.gz`, kept as
  package data next to this module (`MDT_TPU_BPE_PATH` overrides the
  location),
* CLIP's word split, lowercasing and whitespace cleanup.

CLIP splits words with the `regex` pattern
`<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`.
The standard `re` has no `\\p{..}` classes, so `_words` scans the text with
the same alternatives in the same order, classifying each character by its
Unicode category (`unicodedata`). ftfy is not used; `html.unescape` and NFC
normalization cover the CALVIN instruction strings, as in the JAX package.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

__all__ = ["SimpleTokenizer", "tokenize", "default_bpe_path"]

# the pattern's literal alternatives, tried first at every position
_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve", "'m",
             "'ll", "'d")


def default_bpe_path() -> Path:
    """OpenAI's published CLIP BPE merges table, kept as package data
    (MDT_TPU_BPE_PATH overrides)."""
    env = os.environ.get("MDT_TPU_BPE_PATH")
    candidates = ([Path(env)] if env else []) + [
        Path(__file__).resolve().parent / "bpe_simple_vocab_16e6.txt.gz",
    ]
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        "CLIP BPE vocab not found; set MDT_TPU_BPE_PATH to "
        "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def bytes_to_unicode():
    """GPT-2's reversible byte -> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = unicodedata.normalize("NFC", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def _kind(ch: str) -> str:
    """"L" letter, "N" number, "S" whitespace, "O" anything else."""
    if ch.isspace():
        return "S"
    major = unicodedata.category(ch)[0]
    return major if major in "LN" else "O"


def _words(text: str) -> List[str]:
    """What `regex.findall` of CLIP's pattern returns: at each position the
    first alternative that matches; letters and "other" characters in runs,
    numbers one at a time, whitespace skipped."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        lit = next((w for w in _LITERALS if text.startswith(w, i)), None)
        if lit is not None:
            out.append(lit)
            i += len(lit)
            continue
        kind = _kind(text[i])
        j = i + 1
        if kind in "LO":
            while j < n and _kind(text[j]) == kind:
                j += 1
        if kind != "S":
            out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    def __init__(self, bpe_path=None):
        bpe_path = Path(bpe_path) if bpe_path else default_bpe_path()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        for token in _words(_clean(text).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")


_DEFAULT: SimpleTokenizer | None = None


def tokenize(texts: Union[str, Sequence[str]], context_length: int = 77,
             truncate: bool = True) -> np.ndarray:
    """Text(s) -> (B, context_length) int32 ids with SOT/EOT."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = SimpleTokenizer()
    if isinstance(texts, str):
        texts = [texts]
    sot = _DEFAULT.encoder["<|startoftext|>"]
    eot = _DEFAULT.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [sot] + _DEFAULT.encode(text) + [eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"input too long for context {context_length}: {text!r}")
            ids = ids[:context_length]
            ids[-1] = eot
        out[i, : len(ids)] = ids
    return out
