"""First-party WordPiece tokenizer: raw text -> token ids.

The port's copy of tpudl.data.tokenizer (pure Python, so the port keeps
its own rather than import the JAX package). BERT-uncased basic
tokenization (clean -> whitespace -> lowercase+strip accents ->
punctuation/CJK splitting) followed by greedy longest-match-first
WordPiece with "##" continuations, byte-compatible with
transformers.BertTokenizer over the same vocab file. The same corpus
gives tpudl's vocab file and ids (tests/test_torch_tokenizers.py).

No pretrained vocab can be downloaded, so ``build_wordpiece_vocab``
trains one from a corpus: a frequency-based trainer (count all subwords
of known words, keep the ``vocab_size`` most frequent, respecting the
char-level base so nothing un-tokenizable remains). Swap in a real
vocab.txt for production.
"""

from __future__ import annotations

import collections
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = (PAD, UNK, CLS, SEP, MASK)


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric printables count as punctuation (HF rule:
    # treats $, +, ~ etc. as splittable even though unicode disagrees).
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (
        123 <= cp <= 126
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT BasicTokenizer: clean, space CJK, whitespace-split, lowercase
    + strip accents, split on punctuation."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            cleaned += [" ", ch, " "]
        elif _is_whitespace(ch):
            cleaned.append(" ")
        else:
            cleaned.append(ch)
    tokens = []
    for word in "".join(cleaned).split():
        if lowercase:
            word = word.lower()
            word = "".join(
                ch
                for ch in unicodedata.normalize("NFD", word)
                if unicodedata.category(ch) != "Mn"
            )
        # split on punctuation
        current: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
    return tokens


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a BERT-style vocab."""

    def __init__(
        self,
        vocab: "Dict[str, int] | Sequence[str]",
        lowercase: bool = True,
        max_input_chars_per_word: int = 100,
    ):
        if not isinstance(vocab, dict):
            vocab = {tok: i for i, tok in enumerate(vocab)}
        self.vocab: Dict[str, int] = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.max_input_chars_per_word = max_input_chars_per_word
        missing = [t for t in (PAD, UNK, CLS, SEP) if t not in self.vocab]
        if missing:
            raise ValueError(f"vocab lacks required special tokens {missing}")
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]

    # -- construction ------------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str, **kwargs) -> "WordPieceTokenizer":
        """Load a BERT vocab.txt (one token per line, line number = id) —
        the exact file format transformers.BertTokenizer reads."""
        with open(path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        return cls(tokens, **kwargs)

    def save_vocab(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for i in range(len(self.inv_vocab)):
                f.write(self.inv_vocab[i] + "\n")

    # -- tokenization ------------------------------------------------------
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in basic_tokenize(text, self.lowercase):
            out.extend(self.wordpiece(word))
        return out

    def encode(
        self, text: str, max_len: int
    ) -> Tuple[List[int], List[int]]:
        """[CLS] tokens [SEP] + padding -> (ids, attention_mask)."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = [self.cls_id] + ids[: max_len - 2] + [self.sep_id]
        mask = [1] * len(ids)
        pad = max_len - len(ids)
        return ids + [self.pad_id] * pad, mask + [0] * pad

    def __call__(
        self, texts: Iterable[str], max_len: int
    ) -> Dict[str, np.ndarray]:
        ids, masks = [], []
        for t in texts:
            i, m = self.encode(t, max_len)
            ids.append(i)
            masks.append(m)
        return {
            "input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(masks, np.int32),
        }


def build_wordpiece_vocab(
    texts: Iterable[str],
    vocab_size: int = 4096,
    lowercase: bool = True,
    min_frequency: int = 2,
) -> List[str]:
    """Train a WordPiece vocab from a corpus (frequency-based).

    Guarantees: specials first (PAD id 0, the BERT convention), then every
    single character seen (with its "##" continuation form), then whole
    words and "##"-suffixes by descending corpus frequency until
    ``vocab_size`` — so greedy matching can always fall back to characters
    and nothing maps to [UNK] that appeared in training text.
    """
    word_counts: collections.Counter = collections.Counter()
    for text in texts:
        word_counts.update(basic_tokenize(text, lowercase))

    char_tokens: "collections.OrderedDict[str, None]" = collections.OrderedDict()
    sub_counts: collections.Counter = collections.Counter()
    for word, n in word_counts.items():
        for ch in word:
            char_tokens.setdefault(ch, None)
            char_tokens.setdefault("##" + ch, None)
        # substrings anchored at position boundaries (whole word + all
        # prefixes / continuations)
        for i in range(len(word)):
            for j in range(i + 1, len(word) + 1):
                sub = word[i:j] if i == 0 else "##" + word[i:j]
                sub_counts[sub] += n

    vocab: List[str] = list(SPECIALS)
    seen = set(vocab)
    for tok in char_tokens:
        if tok not in seen:
            vocab.append(tok)
            seen.add(tok)
    for tok, n in sub_counts.most_common():
        if len(vocab) >= vocab_size:
            break
        if n < min_frequency:
            break
        if tok not in seen:
            vocab.append(tok)
            seen.add(tok)
    return vocab
