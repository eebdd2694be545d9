"""The port's tokenizers (tpudl_torch.data.tokenizer, WordPiece;
tpudl_torch.data.bpe, byte-level BPE) against tpudl's on the same seeded
corpus: tpudl.data.datasets.synthetic_review sentences mixed with
accents, CJK, control characters, emoji and odd whitespace.

Tokenization is text work, so everything is held exactly: the trained
vocab files and merges byte for byte, the ids, and each package loading
the other's saved files.
"""

import json

import numpy as np
import pytest

from tpudl.data import bpe as jbpe
from tpudl.data import tokenizer as jtok
from tpudl.data.datasets import synthetic_review as jreview
from tpudl_torch.data import bpe as tbpe
from tpudl_torch.data import tokenizer as ttok
from tpudl_torch.data.datasets import synthetic_review

_EXTRA = [
    "Café déjà vu — naïve CRÈME brûlée!",
    "東京の映画は素晴らしい 但是 有点长",
    "tabs\tand\nnewlines\r\nand nbsp　ideographic space",
    "control\x00chars\x07 and � replacement ​ zero-width",
    "emoji 🎬🍿 and math ∑∫ and $5.99 + 50% ~tilde~ <tag>",
    "can't won't it's we'll they've I'm you'd",
    "   leading and trailing   ",
    "",
    "x" * 130,
    "Ünïcödé ÅNGSTRÖM ﬁ ligature ａｂｃ fullwidth",
]


def _corpus(seed=0, n=120):
    rng = np.random.default_rng(seed)
    texts = [synthetic_review(rng, int(rng.integers(0, 2))) for _ in range(n)]
    return texts + _EXTRA * 3


def test_corpus_and_basic_tokenize_match_tpudl():
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    assert [synthetic_review(a, i % 2) for i in range(20)] == \
        [jreview(b, i % 2) for i in range(20)]
    for text in _corpus():
        for lower in (True, False):
            assert ttok.basic_tokenize(text, lower) == \
                jtok.basic_tokenize(text, lower), text


@pytest.mark.parametrize("vocab_size,min_frequency", [(160, 2), (600, 1)])
def test_wordpiece_vocab_and_ids_match_tpudl(tmp_path, vocab_size,
                                             min_frequency):
    corpus = _corpus()
    vocab = ttok.build_wordpiece_vocab(corpus, vocab_size,
                                       min_frequency=min_frequency)
    assert vocab == jtok.build_wordpiece_vocab(corpus, vocab_size,
                                               min_frequency=min_frequency)
    assert vocab[:5] == list(ttok.SPECIALS)
    tok, jt = ttok.WordPieceTokenizer(vocab), jtok.WordPieceTokenizer(vocab)
    tok.save_vocab(str(tmp_path / "port.txt"))
    jt.save_vocab(str(tmp_path / "tpudl.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "tpudl.txt").read_bytes()
    # Each loads the other's file.
    tok2 = ttok.WordPieceTokenizer.from_vocab_file(str(tmp_path / "tpudl.txt"))
    jt2 = jtok.WordPieceTokenizer.from_vocab_file(str(tmp_path / "port.txt"))
    held_out = _corpus(seed=9, n=40)
    for a, b in ((tok, jt), (tok2, jt2), (tok, jt2)):
        for text in held_out:
            assert a.tokenize(text) == b.tokenize(text), text
        for max_len in (8, 48):
            got, want = a(held_out, max_len), b(held_out, max_len)
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="special tokens"):
        ttok.WordPieceTokenizer(["a", "b"])


@pytest.mark.parametrize("vocab_size,min_frequency", [(300, 2), (420, 1)])
def test_bpe_merges_and_ids_match_tpudl(tmp_path, vocab_size, min_frequency):
    corpus = _corpus(seed=1, n=60)
    tok = tbpe.train_bpe(corpus, vocab_size, min_frequency=min_frequency)
    jt = jbpe.train_bpe(corpus, vocab_size, min_frequency=min_frequency)
    assert tok.merges == jt.merges and tok.vocab == jt.vocab
    assert len(tok.merges) > 20
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    tok.save(str(tmp_path / "port"))
    jt.save(str(tmp_path / "tpudl"))
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "tpudl" / name).read_bytes()
    # Each loads the other's files.
    tok2 = tbpe.ByteBPETokenizer.from_files(
        str(tmp_path / "tpudl" / "vocab.json"),
        str(tmp_path / "tpudl" / "merges.txt"))
    jt2 = jbpe.ByteBPETokenizer.from_files(
        str(tmp_path / "port" / "vocab.json"),
        str(tmp_path / "port" / "merges.txt"))
    held_out = _corpus(seed=8, n=30)
    for a, b in ((tok, jt), (tok2, jt2), (tok2, jt)):
        for text in held_out:
            ids = a.encode_text(text)
            assert ids == b.encode_text(text), text
            assert a.decode(ids) == b.decode(ids) == text
        got, want = a(held_out, 40), b(held_out, 40)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    assert json.loads((tmp_path / "port" / "vocab.json").read_text(
        encoding="utf-8"))[tbpe.PAD_TOKEN] == 0
    with pytest.raises(ValueError, match="pad token"):
        tbpe.ByteBPETokenizer({"a": 0}, [])
    with pytest.raises(ValueError, match="duplicate"):
        tbpe.train_bpe(["a"], 300, specials=("<p>", "<p>"))


def test_bpe_imports_regex_on_first_use():
    """tpudl's lazy import stays: loading the module does not import the
    regex package."""
    import subprocess
    import sys

    code = ("import sys, tpudl_torch.data.bpe\n"
            "print('regex' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
