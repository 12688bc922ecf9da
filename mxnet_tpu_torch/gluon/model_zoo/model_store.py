"""Pretrained-weight files of the model zoo (port of
`mxnet_tpu/gluon/model_zoo/model_store.py`).

`get_model_file(name, root)` finds `<name>.params` (or the reference's
hash-suffixed `<name>-<short hash>.params`, for a name with a registered
hash) under `root` (by default ~/.mxnet/models) or in the directory
MXNET_GLUON_REPO names. A `file://` MXNET_GLUON_REPO is a repository the
file is copied from into `root` (`gluon.utils.download`); the port
fetches nothing over a network, so an http(s) repository raises. No
weights ship with the repository: without the file, `pretrained=True`
raises the reference's message.
"""
from __future__ import annotations

import os

_DEFAULT_ROOT = os.path.join("~", ".mxnet", "models")

#: sha1 digests by model name; empty, as the reference's (its role is the
#: hash-suffixed file name of a registered model)
_model_sha1 = {}


def short_hash(name):
    """The first 8 hex digits of the model's registered sha1."""
    if name not in _model_sha1:
        raise ValueError("Pretrained model for %s is not available "
                         "(no published hash registered)" % name)
    return _model_sha1[name][:8]


def get_model_file(name, root=_DEFAULT_ROOT):
    """The path of the model's parameter file, found or copied as the
    module's docstring says."""
    root = os.path.expanduser(root or _DEFAULT_ROOT)
    search = [root]
    repo = os.environ.get("MXNET_GLUON_REPO")
    repo_url = None
    if repo and repo.startswith("file://"):
        repo_url = repo.rstrip("/")
    elif repo and repo.startswith(("http://", "https://")):
        raise IOError("MXNET_GLUON_REPO=%s: the port reads weights from a "
                      "local directory or a file:// repository only"
                      % repo)
    elif repo:
        search.append(os.path.expanduser(repo))
    candidates = [name + ".params"]
    if name in _model_sha1:
        candidates.append("%s-%s.params" % (name, short_hash(name)))
    for base in search:
        for fname in candidates:
            file_path = os.path.join(base, fname)
            if os.path.exists(file_path):
                return file_path
    if repo_url is not None:
        from ..utils import download
        return download("%s/%s" % (repo_url, candidates[-1]),
                        path=os.path.join(root, candidates[-1]),
                        sha1_hash=_model_sha1.get(name))
    raise IOError(
        "Pretrained weights %s.params not found under %s and cannot be "
        "downloaded (no MXNET_GLUON_REPO url configured). Train from "
        "scratch or place the file there." % (name, " or ".join(search)))


def purge(root=_DEFAULT_ROOT):
    """Remove every .params file under `root`."""
    root = os.path.expanduser(root)
    if os.path.exists(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))
