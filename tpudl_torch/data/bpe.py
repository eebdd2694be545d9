"""First-party byte-level BPE tokenizer: the Llama-family text vertical.

The port's copy of tpudl.data.bpe. Llama-family models tokenize with
byte-level BPE (GPT-2 lineage: UTF-8 bytes mapped to printable unicode
symbols, regex pre-tokenization, learned merge ranks). This is the
trainer, the encoder and the GPT-2-format vocab.json/merges.txt
persistence, so raw text feeds the LoRA fine-tune without pre-tokenized
ids. The files are tpudl's: each package loads the other's, and the same
corpus gives the same merges and ids (tests/test_torch_tokenizers.py).
Encodings match transformers.GPT2Tokenizer over the same vocab/merges
files. The ``regex`` module is imported on first use.
"""

from __future__ import annotations

import collections
import json
import os
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

#: Default specials for a freshly trained vocab. <|endoftext|> doubles as
#: the GPT-2-compatibility token (transformers.GPT2Tokenizer's default
#: unk/bos/eos), so our saved files load there without overrides.
PAD_TOKEN = "<|pad|>"
EOT_TOKEN = "<|endoftext|>"
DEFAULT_SPECIALS = (PAD_TOKEN, EOT_TOKEN)

#: GPT-2 pre-tokenization pattern (contractions | letter runs | digit
#: runs | other-symbol runs | trailing/other whitespace), unicode-aware —
#: needs the `regex` module for \p classes.
SPLIT_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
    r"|\s+(?!\S)|\s+"
)


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (the GPT-2 scheme): the
    188 visually-printable latin-1 bytes map to themselves; the rest are
    assigned code points 256+ in order, so every byte string becomes a
    clean unicode string with no whitespace/control ambiguity."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {}
    shift = 0
    for b in range(256):
        if b in printable:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _pretokenize(text: str) -> List[str]:
    import regex

    byte_map = bytes_to_unicode()
    return [
        "".join(byte_map[b] for b in tok.encode("utf-8"))
        for tok in regex.findall(SPLIT_PATTERN, text)
    ]


def _pairs(symbols: Sequence[str]) -> set:
    return {
        (symbols[i], symbols[i + 1]) for i in range(len(symbols) - 1)
    }


class ByteBPETokenizer:
    """Byte-level BPE encoder over a (vocab, merges) pair."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        pad_token: str = PAD_TOKEN,
        bos_token: str = EOT_TOKEN,
    ):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.merges = [tuple(m) for m in merges]
        for name, tok in (("pad", pad_token), ("bos", bos_token)):
            if tok not in self.vocab:
                raise ValueError(f"vocab lacks the {name} token {tok!r}")
        self.pad_token, self.bos_token = pad_token, bos_token
        self.pad_id = self.vocab[pad_token]
        self.bos_id = self.vocab[bos_token]
        self._bpe_cache: Dict[str, List[str]] = {}

    # -- persistence (GPT-2 file formats) ----------------------------------
    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str, **kwargs):
        """Load a GPT-2-format vocab.json + merges.txt pair — the exact
        files transformers.GPT2Tokenizer reads (parity guaranteed over
        the same pair)."""
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges, **kwargs)

    def save(self, directory: str) -> Tuple[str, str]:
        os.makedirs(directory, exist_ok=True)
        vocab_path = os.path.join(directory, "vocab.json")
        merges_path = os.path.join(directory, "merges.txt")
        with open(vocab_path, "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        with open(merges_path, "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")
        return vocab_path, merges_path

    # -- encoding ----------------------------------------------------------
    def bpe(self, word: str) -> List[str]:
        """Apply merges lowest-rank-first to one pre-token (symbols are
        byte-unicode chars)."""
        cached = self._bpe_cache.get(word)
        if cached is not None:
            return cached
        symbols = list(word)
        while len(symbols) > 1:
            pairs = _pairs(symbols)
            best = min(
                pairs, key=lambda p: self.ranks.get(p, float("inf"))
            )
            if best not in self.ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(symbols):
                if (
                    i < len(symbols) - 1
                    and (symbols[i], symbols[i + 1]) == best
                ):
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        self._bpe_cache[word] = symbols
        return symbols

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in _pretokenize(text):
            out.extend(self.bpe(word))
        return out

    def encode_text(self, text: str) -> List[int]:
        """Raw BPE ids, no specials — byte-matches GPT2Tokenizer over the
        same files. Unknown symbols cannot occur: the trained base vocab
        contains all 256 byte tokens."""
        return [self.vocab[t] for t in self.tokenize(text)]

    def decode(self, ids: Iterable[int]) -> str:
        byte_map = bytes_to_unicode()
        inv_byte = {c: b for b, c in byte_map.items()}
        specials = {self.pad_id, self.bos_id}
        chars = "".join(
            self.inv_vocab[i] for i in ids if i not in specials
        )
        return bytes(inv_byte[c] for c in chars).decode(
            "utf-8", errors="replace"
        )

    def encode(self, text: str, max_len: int) -> Tuple[List[int], List[int]]:
        """<bos> + ids, right-padded -> (ids, attention_mask) — the same
        batch contract as WordPieceTokenizer.encode, so
        tokenize_text_dataset takes either tokenizer unchanged."""
        ids = [self.bos_id] + self.encode_text(text)[: max_len - 1]
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


def train_bpe(
    texts: Iterable[str],
    vocab_size: int = 4096,
    specials: Sequence[str] = DEFAULT_SPECIALS,
    min_frequency: int = 2,
) -> ByteBPETokenizer:
    """Train byte-level BPE from a corpus (the classic merge-count loop).

    Base vocab: ``specials`` first (pad id 0), then the 256 byte symbols —
    so any byte sequence tokenizes (no UNK at the byte level, the property
    that makes byte BPE the Llama-family choice). Then repeatedly merge
    the most frequent adjacent symbol pair (ties broken lexicographically
    for determinism) until ``vocab_size`` tokens or no pair reaches
    ``min_frequency``.
    """
    word_freqs: collections.Counter = collections.Counter()
    for text in texts:
        word_freqs.update(_pretokenize(text))

    words: List[List[str]] = [list(w) for w in word_freqs]
    freqs: List[int] = [word_freqs[w] for w in word_freqs]

    vocab: List[str] = list(specials) + list(bytes_to_unicode().values())
    seen = set(vocab)
    if len(seen) != len(vocab):
        raise ValueError(f"duplicate tokens in specials {specials}")
    merges: List[Tuple[str, str]] = []

    while len(vocab) < vocab_size:
        pair_counts: collections.Counter = collections.Counter()
        for symbols, n in zip(words, freqs):
            for i in range(len(symbols) - 1):
                pair_counts[(symbols[i], symbols[i + 1])] += n
        if not pair_counts:
            break
        best, count = max(
            pair_counts.items(), key=lambda kv: (kv[1], kv[0])
        )
        if count < min_frequency:
            break
        merged_tok = best[0] + best[1]
        if merged_tok in seen:
            # Already minted by an earlier merge path; the pair is still
            # recorded so encoding reaches the existing token.
            pass
        else:
            vocab.append(merged_tok)
            seen.add(merged_tok)
        merges.append(best)
        for symbols in words:
            i = 0
            while i < len(symbols) - 1:
                if (symbols[i], symbols[i + 1]) == best:
                    symbols[i : i + 2] = [merged_tok]
                else:
                    i += 1

    return ByteBPETokenizer({t: i for i, t in enumerate(vocab)}, merges)
