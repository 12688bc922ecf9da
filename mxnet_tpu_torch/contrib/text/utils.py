"""Text utilities (port of `mxnet_tpu/contrib/text/utils.py`)."""
from __future__ import annotations

import re
from collections import Counter


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """A Counter of the tokens of `source_str` split at both delimiters
    (lower-cased with to_lower), added to `counter_to_update` when
    given."""
    tokens = [t for t in re.split(
        "(%s|%s)" % (re.escape(token_delim), re.escape(seq_delim)),
        source_str) if t and t not in (token_delim, seq_delim)]
    if to_lower:
        tokens = [t.lower() for t in tokens]
    counter = counter_to_update if counter_to_update is not None \
        else Counter()
    counter.update(tokens)
    return counter
