"""Word-level language-model datasets (port of
`mxnet_tpu/gluon/contrib/data/text.py`): WikiText2 and WikiText103 yield
(data, label) windows of `seq_len` tokens, the label the data shifted by
one, with a vocabulary built from the corpus.

The `wiki.<segment>.tokens` files are read from `root` when they are
there; nothing is downloaded. Otherwise a deterministic synthetic corpus
(Zipf-distributed words in sentences of 5-24) stands in, the reference's
own, so the vocabulary, the indices and the windows are the same in both
packages. Items are host (CPU) NDArrays, as every dataset's are.
"""
from __future__ import annotations

import logging
import os
import re
from collections import Counter

import numpy as np

from ....context import cpu
from ....ndarray import NDArray
from ...data.dataset import Dataset

_EOS = "<eos>"


def _count_tokens(text):
    """Token frequencies of `text`, split on spaces and newlines."""
    return Counter(t for t in re.split("[ \n]", text) if t)


class Vocabulary:
    """Index 0 the unknown token, then the reserved tokens, then the
    counted tokens by falling frequency (ties in sorted order): the
    reference's `contrib.text.Vocabulary` contract."""

    def __init__(self, counter, unknown_token="<unk>", reserved_tokens=()):
        self.unknown_token = unknown_token
        self.idx_to_token = [unknown_token] + list(reserved_tokens)
        self.token_to_idx = {t: i for i, t in enumerate(self.idx_to_token)}
        pairs = sorted(counter.items(), key=lambda kv: kv[0])
        pairs.sort(key=lambda kv: kv[1], reverse=True)
        for token, _ in pairs:
            if token not in self.token_to_idx:
                self.token_to_idx[token] = len(self.idx_to_token)
                self.idx_to_token.append(token)

    def __len__(self):
        return len(self.idx_to_token)

    def to_indices(self, tokens):
        """The index of a token, or a list of them (unknowns are 0)."""
        if isinstance(tokens, (list, tuple)):
            return [self.token_to_idx.get(t, 0) for t in tokens]
        return self.token_to_idx.get(tokens, 0)


def _synthetic_corpus(n_sentences, vocab_size, seed):
    """Zipf-ish word stream with sentence breaks (deterministic)."""
    rng = np.random.RandomState(seed)
    words = ["w%03d" % i for i in range(vocab_size)]
    p = 1.0 / np.arange(1, vocab_size + 1)
    p /= p.sum()
    lines = []
    for _ in range(n_sentences):
        length = rng.randint(5, 25)
        lines.append(" ".join(rng.choice(words, size=length, p=p)))
    return "\n".join(lines)


_FILES = {"train": "wiki.train.tokens", "validation": "wiki.valid.tokens",
          "test": "wiki.test.tokens"}
_SEEDS = {"train": 11, "validation": 12, "test": 13}


class _WikiText(Dataset):
    def __init__(self, root, segment, vocab, seq_len, synth_sentences,
                 synth_vocab):
        if segment not in _FILES:
            raise ValueError("segment must be one of %s" % sorted(_FILES))
        self._seq_len = int(seq_len)
        self._vocab = vocab
        path = os.path.join(os.path.expanduser(root), _FILES[segment])
        if os.path.exists(path):
            with open(path, encoding="utf8") as f:
                content = f.read()
        else:
            logging.warning(
                "%s: %s not found; substituting the deterministic "
                "synthetic corpus (perplexities are not comparable to the "
                "real dataset's)", type(self).__name__, path)
            content = _synthetic_corpus(synth_sentences, synth_vocab,
                                        _SEEDS[segment])
        self._counter = _count_tokens(content)
        if self._vocab is None:
            self._vocab = Vocabulary(self._counter, reserved_tokens=[_EOS])
        tokens = []
        for line in content.splitlines():
            parts = line.strip().split()
            if parts:
                tokens.extend(parts)
                tokens.append(_EOS)
        idx = np.asarray(self._vocab.to_indices(tokens), np.int32)
        n = (len(idx) - 1) // self._seq_len
        self._data = idx[:n * self._seq_len].reshape(n, self._seq_len)
        self._label = idx[1:n * self._seq_len + 1].reshape(n, self._seq_len)

    @property
    def vocabulary(self):
        return self._vocab

    @property
    def frequencies(self):
        return self._counter

    def __getitem__(self, i):
        return (NDArray(self._data[i], ctx=cpu()),
                NDArray(self._label[i], ctx=cpu()))

    def __len__(self):
        return len(self._label)


class WikiText2(_WikiText):
    """WikiText-2; its synthetic stand-in has 2000 sentences over 600
    words."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "wikitext-2"),
                 segment="train", vocab=None, seq_len=35):
        super().__init__(root, segment, vocab, seq_len, 2000, 600)


class WikiText103(_WikiText):
    """WikiText-103; its synthetic stand-in has 8000 sentences over 2000
    words."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "wikitext-103"),
                 segment="train", vocab=None, seq_len=35):
        super().__init__(root, segment, vocab, seq_len, 8000, 2000)
