"""RecordIO files (port of `mxnet_tpu/recordio.py`): MXRecordIO and
MXIndexedRecordIO with dmlc-core's framing (a little-endian magic and
length before each record, records padded to 4 bytes, a tab-separated
`.idx` of key and offset), and the image-record header
(pack / unpack / pack_img / unpack_img). The byte format is the
contract: a file either package writes, the other reads, and packs made
by MXNet's tools/im2rec read unchanged. Host-side: plain files and
numpy.
"""
from __future__ import annotations

import os
import struct
import collections

import numpy as np

_MAGIC = 0xced7230a


class MXRecordIO:
    """Sequential reader ('r') or writer ('w') of one RecordIO file."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.fp = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fp = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        self.fp.close()
        self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        del d["fp"]
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        is_open = d["is_open"]
        self.is_open = False
        if is_open:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.fp.tell()

    def write(self, buf):
        assert self.writable
        self.fp.write(struct.pack("<II", _MAGIC, len(buf)))
        self.fp.write(buf)
        pad = (4 - (len(buf) % 4)) % 4
        if pad:
            self.fp.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        header = self.fp.read(8)
        if len(header) < 8:
            return None
        magic, length = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise IOError("Invalid RecordIO magic in %s" % self.uri)
        buf = self.fp.read(length)
        pad = (4 - (length % 4)) % 4
        if pad:
            self.fp.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with random access through its `.idx` file (written when
    a writer closes, read when a reader opens)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        pos = self.idx[idx]
        self.fp.seek(pos)

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """A record: the IRHeader (a scalar label, or an array label whose
    size goes in `flag`) and the payload bytes."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                          header.id2)
        return hdr + s
    label = np.asarray(header.label, dtype=np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """(IRHeader, payload bytes) of a record; an array label comes back
    as float32."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=1):
    """(IRHeader, the decoded HWC uint8 image as numpy)."""
    from . import image
    header, img_bytes = unpack(s)
    img = image.imdecode(img_bytes, flag=iscolor)
    return header, img.asnumpy()


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """A record of the header and `img` encoded as img_fmt."""
    from . import image
    buf = image.imencode(img, quality=quality, img_fmt=img_fmt)
    return pack(header, buf)
