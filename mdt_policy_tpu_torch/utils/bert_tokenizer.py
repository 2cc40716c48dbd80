"""BERT's WordPiece tokenizer over a `vocab.txt`, in pure Python: the port's
copy of what `transformers.BertTokenizerFast` computes for the MiniLM
sentence encoder (`mdt_policy_tpu/models/minilm.py:203-205` calls it). The
card's machine has no `transformers`, so the port keeps its own, as it does
with CLIP's BPE tokenizer (`utils/clip_tokenizer.py`).

The steps are those of the fast tokenizer's normalizer, pre-tokenizer,
model and post-processor:

* clean the text: drop NUL, U+FFFD and control characters (Unicode `C*`
  other than tab, newline and carriage return); map whitespace to a space;
* put spaces around CJK ideographs;
* with `do_lower_case`: strip accents (NFD, then drop the `Mn` marks) and
  lower-case;
* split on whitespace, and make every punctuation character (ASCII 33-47,
  58-64, 91-96, 123-126, and every Unicode `P*`) a word of its own;
* WordPiece: greedy longest match first, pieces after the first prefixed
  with `##`; a word longer than 100 characters, or one with a piece that
  does not match, becomes `[UNK]`;
* `[CLS]` + pieces cut to `max_length - 2` + `[SEP]`, padded with `[PAD]`'s
  id to `max_length`.
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence, Union

import numpy as np

__all__ = ["BertTokenizer", "load_vocab"]

MAX_WORD_CHARS = 100
_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
               (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def load_vocab(path) -> Dict[str, int]:
    """token -> id, the id being the line number (a later duplicate wins)."""
    lines = Path(path).read_text(encoding="utf-8").split("\n")
    if lines and lines[-1] == "":
        lines.pop()  # the newline that ends the file
    return {token: i for i, token in enumerate(lines)}


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or ch.isspace()


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


class BertTokenizer:
    """`tokenizer(texts, max_length)` -> {"input_ids", "attention_mask"},
    int64 arrays (len(texts), max_length), as `BertTokenizerFast(vocab,
    do_lower_case=...)(texts, padding="max_length", truncation=True,
    max_length=max_length)` gives them."""

    def __init__(self, vocab_file, do_lower_case: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]"):
        self.vocab = load_vocab(vocab_file)
        self.do_lower_case = do_lower_case
        self.unk_id = self.vocab[unk_token]
        self.cls_id, self.sep_id = self.vocab[cls_token], self.vocab[sep_token]
        self.pad_id = self.vocab[pad_token]
        self.unk_token = unk_token

    def normalize(self, text: str) -> str:
        out = []
        for ch in text:
            if ch in "\x00\ufffd" or _is_control(ch):
                continue
            if _is_whitespace(ch):
                out.append(" ")
            elif _is_cjk(ch):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        text = "".join(out)
        if self.do_lower_case:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
            text = text.lower()
        return text

    @staticmethod
    def pre_tokenize(text: str) -> List[str]:
        words = []
        for chunk in text.split():
            word = []
            for ch in chunk:
                if _is_punctuation(ch):
                    if word:
                        words.append("".join(word))
                        word = []
                    words.append(ch)
                else:
                    word.append(ch)
            if word:
                words.append("".join(word))
        return words

    def wordpiece(self, word: str) -> List[int]:
        if len(word) > MAX_WORD_CHARS:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            if end == start:
                return [self.unk_id]
            start = end
        return ids

    def encode(self, text: str, max_length: int) -> List[int]:
        pieces = [i for w in self.pre_tokenize(self.normalize(text)) for i in self.wordpiece(w)]
        return [self.cls_id] + pieces[:max(max_length - 2, 0)] + [self.sep_id]

    def __call__(self, texts: Union[str, Sequence[str]], max_length: int):
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), max_length), self.pad_id, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for row, text in enumerate(texts):
            enc = self.encode(text, max_length)
            ids[row, :len(enc)] = enc
            mask[row, :len(enc)] = 1
        return {"input_ids": ids, "attention_mask": mask}
