"""Text vocabulary (port of `mxnet_tpu/contrib/text/vocab.py`).

Index 0 is the unknown token, the reserved tokens follow, then the
counter's keys by descending frequency (ties in sorted order), those
below min_freq dropped and at most most_freq_count kept.
"""
from __future__ import annotations


class Vocabulary:
    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be >= 1")
        if reserved_tokens is not None:
            if unknown_token in reserved_tokens:
                raise ValueError("unknown_token cannot be reserved")
            if len(set(reserved_tokens)) != len(reserved_tokens):
                raise ValueError("reserved_tokens cannot repeat")
        self._unknown_token = unknown_token
        self._reserved_tokens = list(reserved_tokens) \
            if reserved_tokens else None
        self._idx_to_token = [unknown_token] + (self._reserved_tokens or [])
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter_keys(counter, most_freq_count, min_freq)

    def _index_counter_keys(self, counter, most_freq_count, min_freq):
        special = set(self._idx_to_token)
        pairs = sorted(counter.items(), key=lambda kv: kv[0])
        pairs.sort(key=lambda kv: kv[1], reverse=True)
        budget = len(pairs) if most_freq_count is None else most_freq_count
        for token, freq in pairs:
            if freq < min_freq or budget <= 0:
                break
            if token in special:
                continue
            self._token_to_idx[token] = len(self._idx_to_token)
            self._idx_to_token.append(token)
            budget -= 1

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """The index of a token (or a list of indices of a list); an
        unknown token gives 0."""
        single = not isinstance(tokens, (list, tuple))
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        """The token of an index (or a list of tokens of a list); an index
        out of range raises ValueError."""
        single = not isinstance(indices, (list, tuple))
        idxs = [indices] if single else indices
        out = []
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError("token index %d out of range" % i)
            out.append(self._idx_to_token[i])
        return out[0] if single else out
