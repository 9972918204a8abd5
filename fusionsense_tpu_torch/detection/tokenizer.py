"""WordPiece tokenizer with character offsets.

The port's copy of fusionsense_tpu/detection/tokenizer.py (pure Python).

Behavioral contract: GLIP tokenizes the grounding caption with HF
bert-base-uncased (predictor_glip.py:92-105) and builds per-phrase
positive maps from `char_to_token` offsets (:412-445). This is a
self-contained WordPiece implementation (basic tokenizer: lowercase +
whitespace/punctuation split; greedy longest-match subwords) so the
detector runs air-gapped given only a vocab.txt. `char_to_token` matches
the HF fast-tokenizer semantics the positive-map code relies on.
"""
from __future__ import annotations

import dataclasses
import unicodedata
from pathlib import Path


@dataclasses.dataclass
class Encoding:
    ids: list[int]
    mask: list[int]
    offsets: list[tuple[int, int] | None]   # char span per token

    def char_to_token(self, pos: int) -> int | None:
        for i, off in enumerate(self.offsets):
            if off is not None and off[0] <= pos < off[1]:
                return i
        return None


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    def __init__(self, vocab: dict[str, int], max_len: int = 256,
                 lowercase: bool = True):
        self.vocab = vocab
        self.max_len = max_len
        self.lowercase = lowercase
        self.unk = vocab.get("[UNK]", 0)
        self.cls = vocab.get("[CLS]", 0)
        self.sep = vocab.get("[SEP]", 0)
        self.pad = vocab.get("[PAD]", 0)

    @classmethod
    def from_vocab_file(cls, path: str | Path, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    @classmethod
    def toy(cls, captions: list[str], max_len: int = 256):
        """Whole-word vocab built from sample captions — lets architecture
        tests run without the real bert vocab."""
        vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, ".": 4}
        for cap in captions:
            for w in cap.lower().split():
                word = "".join(c for c in w if not _is_punct(c))
                if word and word not in vocab:
                    vocab[word] = len(vocab)
        return cls(vocab, max_len=max_len)

    def _basic_tokens(self, text: str):
        """[(word, start, end)] split on whitespace + punctuation."""
        out = []
        start = None
        for i, ch in enumerate(text):
            if ch.isspace():
                if start is not None:
                    out.append((text[start:i], start, i))
                    start = None
            elif _is_punct(ch):
                if start is not None:
                    out.append((text[start:i], start, i))
                    start = None
                out.append((ch, i, i + 1))
            else:
                if start is None:
                    start = i
        if start is not None:
            out.append((text[start:], start, len(text)))
        return out

    def _wordpiece(self, word: str):
        """Greedy longest-match; returns list of (subword, rel_start,
        rel_end) or None if the word is unknown."""
        pieces = []
        pos = 0
        while pos < len(word):
            end = len(word)
            cur = None
            while end > pos:
                sub = word[pos:end]
                if pos > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = (sub, pos, end)
                    break
                end -= 1
            if cur is None:
                return None
            pieces.append(cur)
            pos = cur[2]
        return pieces

    def encode(self, text: str) -> Encoding:
        if self.lowercase:
            text = text.lower()
        ids = [self.cls]
        offsets: list[tuple[int, int] | None] = [None]
        for word, ws, _we in self._basic_tokens(text):
            pieces = self._wordpiece(word)
            if pieces is None:
                ids.append(self.unk)
                offsets.append((ws, ws + len(word)))
            else:
                for sub, rs, re_ in pieces:
                    ids.append(self.vocab[sub])
                    offsets.append((ws + rs, ws + re_))
            if len(ids) >= self.max_len - 1:
                break
        ids = ids[:self.max_len - 1] + [self.sep]
        offsets = offsets[:self.max_len - 1] + [None]
        mask = [1] * len(ids)
        n_pad = self.max_len - len(ids)
        ids += [self.pad] * n_pad
        mask += [0] * n_pad
        offsets += [None] * n_pad
        return Encoding(ids=ids, mask=mask, offsets=offsets)
