#!/usr/bin/env python
"""Build the .idx sidecar for an existing RecordIO file (port of
tools/rec2idx.py): one "<key>\\t<byte offset>" line per record, enabling
MXIndexedRecordIO random access and sharded reads over a .rec packed
without an index (by a plain MXRecordIO writer or an external producer).

    python -m mxnet_tpu_torch.tools.rec2idx data.rec [data.idx] --device cpu

The index is read and written on the host; `--device` is every port
tool's flag (the card by default, which must then be present).
"""
import argparse
import os
import sys

from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.tools import add_device_flag, require_device


def build_index(rec_path, idx_path, key_from_header=False):
    """Returns the number of records indexed.

    key_from_header=True reads each record's IRHeader and uses its .id as
    the index key (im2rec packs the sample index there); default keys are
    the sequential record ordinal, matching the reference tool.
    """
    reader = recordio.MXRecordIO(rec_path, "r")
    count = 0
    try:
        with open(idx_path, "w") as idx:
            while True:
                pos = reader.tell()
                item = reader.read()
                if item is None:
                    break
                if key_from_header:
                    header, _ = recordio.unpack(item)
                    key = int(header.id)
                else:
                    key = count
                idx.write("%d\t%d\n" % (key, pos))
                count += 1
    finally:
        reader.close()
    return count


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="generate a .idx index for a RecordIO .rec file")
    ap.add_argument("record", help="path to the .rec file")
    ap.add_argument("index", nargs="?", default=None,
                    help="output .idx path (default: <record>.idx with "
                         "the .rec suffix replaced)")
    ap.add_argument("--key-from-header", action="store_true",
                    help="use each record's IRHeader.id as the key "
                         "instead of the sequential ordinal")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    require_device(args.device)
    idx = args.index or (os.path.splitext(args.record)[0] + ".idx")
    n = build_index(args.record, idx, args.key_from_header)
    print("wrote %d entries to %s" % (n, idx))
    return 0


if __name__ == "__main__":
    sys.exit(main())
