"""WordPiece tokenizer with BERT-uncased semantics, no network (the port's own
copy of ``mae_clip_tpu/data/tokenizer.py``, pure Python: the JAX package's
optional C++ fast path gives the same ids and is not used here), plus
``pad_token_batch`` from ``mae_clip_tpu/data/pipeline.py``.

``encode_batch`` pads to the longest sequence in the list (HF
``padding=True``) unless ``fixed_length`` pins a static width.
"""

from __future__ import annotations

import collections
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
       (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or
            (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F) or
            (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF) or
            (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """Whitespace/punctuation/CJK splitting with accent stripping."""
    # Clean: drop control chars and invalid codepoints, normalize whitespace.
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        cleaned.append(" " if _is_whitespace(ch) else ch)
    text = "".join(cleaned)

    # CJK chars become standalone tokens.
    spaced = []
    for ch in text:
        if _is_cjk(ord(ch)):
            spaced.append(f" {ch} ")
        else:
            spaced.append(ch)
    text = "".join(spaced)

    tokens: List[str] = []
    for tok in text.split():
        if lowercase:
            tok = tok.lower()
            tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(c) != "Mn")
        # Split punctuation into separate tokens.
        cur: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    """BERT-uncased-compatible tokenizer over an HF-format vocab.txt."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.cls_token = cls_token
        self.sep_token = sep_token
        self.pad_token = pad_token
        self.max_input_chars_per_word = max_input_chars_per_word

    # -- construction ---------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = collections.OrderedDict()
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    @property
    def pad_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- core algorithm ---------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in basic_tokenize(text, self.lowercase):
            out.extend(self._wordpiece(tok))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    # -- encoding ---------------------------------------------------------
    def _content_ids(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def encode(self, text: str, max_length: Optional[int] = None
               ) -> List[int]:
        """[CLS] tokens [SEP], truncated to max_length total."""
        ids = self._content_ids(text)
        if max_length is not None:
            ids = ids[: max_length - 2]
        return ([self.vocab[self.cls_token]] + ids
                + [self.vocab[self.sep_token]])

    def encode_batch(self, texts: Sequence[str],
                     max_length: Optional[int] = None,
                     fixed_length: Optional[int] = None
                     ) -> Dict[str, List[List[int]]]:
        """HF-style batch encode: ``padding=True`` semantics (pad to the
        longest in THIS list) unless ``fixed_length`` pins a static width."""
        cls_id = self.vocab[self.cls_token]
        sep_id = self.vocab[self.sep_token]
        cut = (max_length - 2) if max_length is not None else None
        encoded = [[cls_id] + list(ids[:cut]) + [sep_id]
                   for ids in map(self._content_ids, texts)]
        width = fixed_length if fixed_length is not None else max(
            (len(e) for e in encoded), default=0)
        pad = self.pad_id
        input_ids, attention_mask = [], []
        for e in encoded:
            e = e[:width]
            mask = [1] * len(e) + [0] * (width - len(e))
            input_ids.append(e + [pad] * (width - len(e)))
            attention_mask.append(mask)
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def build_vocab(corpus: Iterable[str], vocab_size: int = 8192,
                min_frequency: int = 2, lowercase: bool = True
                ) -> Dict[str, int]:
    """Frequency-based WordPiece vocab builder for fully-offline runs.

    Simple iterative scheme: start from characters, greedily add the most
    frequent whole words, then the most frequent prefixes/suffix pieces.
    Not BPE-optimal, but produces a valid vocab this tokenizer (and HF's)
    can consume.
    """
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    word_counts: collections.Counter = collections.Counter()
    for text in corpus:
        for tok in basic_tokenize(text, lowercase):
            word_counts[tok] += 1

    vocab: Dict[str, int] = {t: i for i, t in enumerate(specials)}

    def add(token: str) -> None:
        if token not in vocab and len(vocab) < vocab_size:
            vocab[token] = len(vocab)

    # All single characters (as starts and continuations) for coverage.
    char_counts: collections.Counter = collections.Counter()
    for w, c in word_counts.items():
        for j, ch in enumerate(w):
            char_counts[ch if j == 0 else "##" + ch] += c
    for ch, _ in char_counts.most_common():
        add(ch)

    # Most frequent whole words.
    for w, c in word_counts.most_common():
        if c < min_frequency:
            break
        add(w)

    # Frequent sub-pieces (prefixes + '##'-continuations) of remaining mass.
    piece_counts: collections.Counter = collections.Counter()
    for w, c in word_counts.items():
        for ln in range(2, min(len(w), 12)):
            piece_counts[w[:ln]] += c
            piece_counts["##" + w[ln:]] += c
    for piece, c in piece_counts.most_common():
        if len(vocab) >= vocab_size:
            break
        if c >= min_frequency:
            add(piece)
    return vocab


def pad_token_batch(ids: np.ndarray, mask: np.ndarray, batch_size: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (n, S) token ids + attention mask to ``batch_size`` rows.

    Pad rows keep ONE valid attention token so the attention softmax over
    an all-masked row stays finite.
    """
    pad = batch_size - len(ids)
    if pad <= 0:
        return ids, mask
    ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), ids.dtype)])
    pad_mask = np.zeros((pad, mask.shape[1]), mask.dtype)
    pad_mask[:, 0] = 1
    mask = np.concatenate([mask, pad_mask])
    return ids, mask
