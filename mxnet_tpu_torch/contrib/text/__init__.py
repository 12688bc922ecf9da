"""mx.contrib.text (port of `mxnet_tpu/contrib/text/`): `Vocabulary`,
`utils.count_tokens_from_str`, and the token embeddings of
`embedding`."""
from . import embedding  # noqa: F401
from . import utils  # noqa: F401
from . import vocab  # noqa: F401
from .vocab import Vocabulary  # noqa: F401
