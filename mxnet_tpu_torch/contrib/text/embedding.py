"""Token embeddings (port of `mxnet_tpu/contrib/text/embedding.py`): the
registry (`register`, `create`, `get_pretrained_file_names`), GloVe and
fastText files, `CustomEmbedding` and `CompositeEmbedding`.

The pretrained classes read the published text formats from local files
only: `pretrained_file_path`, or `<embedding_root>/<class name>/<file>`.
A file that is not there raises IOError; nothing is downloaded.
"""
from __future__ import annotations

import io
import os

import numpy as np

from ...ndarray import NDArray
from . import vocab as _vocab

_REGISTRY = {}


def register(embedding_cls):
    """Register an embedding class under its lower-cased name."""
    _REGISTRY[embedding_cls.__name__.lower()] = embedding_cls
    return embedding_cls


def create(embedding_name, **kwargs):
    """An instance of the registered embedding `embedding_name`."""
    name = embedding_name.lower()
    if name not in _REGISTRY:
        raise KeyError("unknown embedding %s (registered: %s)"
                       % (embedding_name, sorted(_REGISTRY)))
    return _REGISTRY[name](**kwargs)


def get_pretrained_file_names(embedding_name=None):
    """The pretrained file names of one embedding, or {name: names} of
    every registered one."""
    if embedding_name is not None:
        cls = _REGISTRY[embedding_name.lower()]
        return list(cls.pretrained_file_names)
    return {n: list(c.pretrained_file_names) for n, c in _REGISTRY.items()}


class _TokenEmbedding(_vocab.Vocabulary):
    """A Vocabulary with a vector a token; row 0 (the unknown token) is
    init_unknown_vec(vec_len), or the file's own vector for it."""

    pretrained_file_names = ()

    def __init__(self, unknown_token="<unk>",
                 init_unknown_vec=np.zeros):
        super().__init__(counter=None, unknown_token=unknown_token)
        self._init_unknown_vec = init_unknown_vec
        self._vec_len = 0
        self._idx_to_vec = None

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return NDArray(self._idx_to_vec)

    def _load_embedding_txt(self, fobj, elem_delim=" "):
        tokens, vecs = [], []
        unk_vec = None
        seen = set(self._token_to_idx)
        for line_num, line in enumerate(fobj):
            parts = line.rstrip().split(elem_delim)
            if line_num == 0 and len(parts) == 2 and \
                    all(p.isdigit() for p in parts):
                continue  # fastText's "<count> <dim>" header
            token, elems = parts[0], parts[1:]
            if len(elems) == 1:
                continue  # a line of one value is not a vector
            if self._vec_len and len(elems) != self._vec_len:
                raise ValueError(
                    "inconsistent vector length at line %d for token %r"
                    % (line_num + 1, token))
            self._vec_len = self._vec_len or len(elems)
            if token == self._unknown_token:
                unk_vec = np.asarray(elems, dtype=np.float32)
                continue
            if token in seen:
                continue  # the first of a repeated token wins
            seen.add(token)
            tokens.append(token)
            vecs.append(np.asarray(elems, dtype=np.float32))
        mat = np.zeros((1 + len(tokens), self._vec_len), np.float32)
        mat[0] = unk_vec if unk_vec is not None \
            else self._init_unknown_vec(self._vec_len)
        for i, (t, v) in enumerate(zip(tokens, vecs), start=1):
            self._token_to_idx[t] = i
            self._idx_to_token.append(t)
            mat[i] = v
        self._idx_to_vec = mat

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        """The vector of a token (rows for a list); an unknown token gets
        row 0, after trying its lower case with lower_case_backup."""
        single = not isinstance(tokens, (list, tuple))
        toks = [tokens] if single else tokens
        idxs = []
        for t in toks:
            i = self._token_to_idx.get(t, 0)
            if i == 0 and lower_case_backup:
                i = self._token_to_idx.get(str(t).lower(), 0)
            idxs.append(i)
        out = self._idx_to_vec[np.asarray(idxs)]
        return NDArray(out[0] if single else out)

    def update_token_vectors(self, tokens, new_vectors):
        """Set the vectors of indexed tokens; an unindexed one raises."""
        toks = [tokens] if not isinstance(tokens, (list, tuple)) else tokens
        vals = np.asarray(new_vectors.asnumpy()
                          if isinstance(new_vectors, NDArray)
                          else new_vectors, dtype=np.float32)
        vals = vals.reshape(len(toks), self._vec_len)
        for t, v in zip(toks, vals):
            if t not in self._token_to_idx:
                raise ValueError("token %r not indexed" % (t,))
            self._idx_to_vec[self._token_to_idx[t]] = v


class _PretrainedFileEmbedding(_TokenEmbedding):
    """A pretrained text file read from `pretrained_file_path` or from
    `embedding_root`/<class name>/`pretrained_file_name`."""

    def __init__(self, pretrained_file_name=None,
                 pretrained_file_path=None,
                 embedding_root=os.path.join("~", ".mxnet", "embeddings"),
                 **kwargs):
        super().__init__(**kwargs)
        path = pretrained_file_path
        if path is None:
            if pretrained_file_name is None:
                raise ValueError("pass pretrained_file_name or "
                                 "pretrained_file_path")
            path = os.path.join(os.path.expanduser(embedding_root),
                                type(self).__name__.lower(),
                                pretrained_file_name)
        if not os.path.exists(path):
            raise IOError(
                "pretrained embedding file %s not found (files are read "
                "locally, never downloaded); place the file there or pass "
                "pretrained_file_path" % path)
        with io.open(path, encoding="utf-8") as f:
            self._load_embedding_txt(f)


@register
class GloVe(_PretrainedFileEmbedding):
    """GloVe's glove.*.txt word-vector files."""

    pretrained_file_names = (
        "glove.42B.300d.txt", "glove.6B.50d.txt", "glove.6B.100d.txt",
        "glove.6B.200d.txt", "glove.6B.300d.txt", "glove.840B.300d.txt",
        "glove.twitter.27B.25d.txt", "glove.twitter.27B.50d.txt",
        "glove.twitter.27B.100d.txt", "glove.twitter.27B.200d.txt")


@register
class FastText(_PretrainedFileEmbedding):
    """fastText's wiki.*.vec files (a count / dim header line)."""

    pretrained_file_names = ("wiki.en.vec", "wiki.simple.vec",
                             "wiki.zh.vec")


@register
class CustomEmbedding(_TokenEmbedding):
    """A user's token-vector text file, `elem_delim` between fields."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf-8", **kwargs):
        super().__init__(**kwargs)
        with io.open(pretrained_file_path, encoding=encoding) as f:
            self._load_embedding_txt(f, elem_delim=elem_delim)


@register
class CompositeEmbedding(_TokenEmbedding):
    """`vocabulary` indexed against one or more token embeddings: a
    token's vector is its vectors in each, concatenated."""

    def __init__(self, vocabulary, token_embeddings):
        if not isinstance(token_embeddings, list):
            token_embeddings = [token_embeddings]
        super().__init__(unknown_token=vocabulary.unknown_token)
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = dict(vocabulary.token_to_idx)
        self._vec_len = sum(e.vec_len for e in token_embeddings)
        self._idx_to_vec = np.concatenate(
            [emb.get_vecs_by_tokens(list(self._idx_to_token)).asnumpy()
             for emb in token_embeddings], axis=1)
