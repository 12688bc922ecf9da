"""Gluon utilities (port of `mxnet_tpu/gluon/utils.py`): split_data,
split_and_load, clip_global_norm, check_sha1 and download."""
from __future__ import annotations

import hashlib
import math
import os
import shutil
import time
import urllib.request

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import NDArray


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """num_slice slices of data along batch_axis (the last takes the
    remainder when even_split is False)."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d." % (str(data.shape), num_slice,
                                                 batch_axis))
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(begin, end)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """data split along batch_axis, one slice on each context; with one
    context the whole batch on it, as the reference does."""
    if not isinstance(ctx_list, (list, tuple)):
        ctx_list = [ctx_list]
    if not isinstance(data, NDArray):
        data = NDArray(np.asarray(data), ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Rescale the arrays in place so that their joint 2-norm is at most
    max_norm; returns the norm before clipping (a host float, so the call
    waits for the device, as the reference's does)."""
    if not arrays:
        raise MXNetError("clip_global_norm needs at least one array")
    total_norm = math.sqrt(sum(
        float(torch.sum(torch.square(a._data.detach().float())))
        for a in arrays))
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a._data = a._data * scale
    return total_norm


def check_sha1(filename, sha1_hash):
    """True when the file's sha1 hex digest is `sha1_hash`."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=3):
    """Fetch `url` (any scheme urllib opens; `file://` needs no network)
    to `path` (a file, or a directory that takes the URL's last
    component; the working directory when None) and return the file's
    path. An existing file that passes the sha1 check (when given) is
    kept unless `overwrite`. The bytes land in a temporary file renamed
    into place, so a failed fetch leaves no partial file; a failure is
    tried `retries` times in all, with a doubling pause between tries,
    then raises IOError."""
    fname = path if path and not os.path.isdir(path) else os.path.join(
        path or ".", url.split("/")[-1])
    if os.path.exists(fname) and not overwrite and (
            not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    tmp = "%s.tmp-%d" % (fname, os.getpid())
    err = None
    for attempt in range(max(1, int(retries))):
        try:
            with urllib.request.urlopen(url, timeout=30) as src, \
                    open(tmp, "wb") as dst:
                shutil.copyfileobj(src, dst)
            if sha1_hash and not check_sha1(tmp, sha1_hash):
                raise IOError("%s fails its sha1 check" % url)
            os.replace(tmp, fname)
            return fname
        except OSError as e:
            err = e
            if attempt + 1 < retries:
                time.sleep(0.2 * 2 ** attempt)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    raise IOError("download(%s) failed after %d attempts (%s); place the "
                  "file at %s by hand" % (url, retries, err, fname))
