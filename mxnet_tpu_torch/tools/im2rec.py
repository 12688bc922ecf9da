#!/usr/bin/env python
"""im2rec: pack an image dataset into RecordIO (port of tools/im2rec.py:
.lst generation and multithreaded packing with an index file for random
access).

Usage:
  python -m mxnet_tpu_torch.tools.im2rec --list prefix image_root   # prefix.lst
  python -m mxnet_tpu_torch.tools.im2rec prefix image_root          # .rec/.idx

Images are read, resized and encoded on the host (PIL), so the files are
byte for byte the reference's; `--device` is every port tool's flag (the
card by default, which must then be present).
"""
from __future__ import annotations

import argparse
import os
import random
import sys
from concurrent.futures import ThreadPoolExecutor

from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.tools import add_device_flag, require_device

_EXTS = {".jpg", ".jpeg", ".png"}


def list_images(root, recursive=True):
    """[(index, path relative to root, label)], one label a directory."""
    cat = {}
    items = []
    i = 0
    for path, dirs, files in sorted(os.walk(root, followlinks=True)):
        dirs.sort()
        for fname in sorted(files):
            if os.path.splitext(fname)[1].lower() not in _EXTS:
                continue
            fpath = os.path.join(path, fname)
            label_key = os.path.relpath(path, root)
            if label_key not in cat:
                cat[label_key] = len(cat)
            items.append((i, os.path.relpath(fpath, root), cat[label_key]))
            i += 1
        if not recursive:
            break
    return items


def write_list(prefix, items, shuffle=False):
    if shuffle:
        random.shuffle(items)
    with open(prefix + ".lst", "w") as f:
        for idx, relpath, label in items:
            f.write("%d\t%f\t%s\n" % (idx, float(label), relpath))


def read_list(path):
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            yield int(parts[0]), [float(x) for x in parts[1:-1]], parts[-1]


def encode_item(root, relpath, labels, idx, quality, resize, center_crop):
    """One packed record: the file's bytes, or with `resize` /
    `center_crop` the image re-encoded as JPEG at `quality`."""
    fpath = os.path.join(root, relpath)
    with open(fpath, "rb") as f:
        buf = f.read()
    if resize or center_crop:
        import io as pyio
        from PIL import Image
        img = Image.open(pyio.BytesIO(buf)).convert("RGB")
        if center_crop:
            side = min(img.size)
            left = (img.size[0] - side) // 2
            top = (img.size[1] - side) // 2
            img = img.crop((left, top, left + side, top + side))
        if resize:
            w, h = img.size
            if w < h:
                img = img.resize((resize, int(h * resize / w)))
            else:
                img = img.resize((int(w * resize / h), resize))
        out = pyio.BytesIO()
        img.save(out, format="JPEG", quality=quality)
        buf = out.getvalue()
    if len(labels) == 1:
        header = recordio.IRHeader(0, labels[0], idx, 0)
    else:
        header = recordio.IRHeader(len(labels), labels, idx, 0)
    return recordio.pack(header, buf)


def make_rec(prefix, root, num_thread=8, quality=95, resize=0,
             center_crop=False):
    items = list(read_list(prefix + ".lst"))
    writer = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    with ThreadPoolExecutor(max_workers=num_thread) as pool:
        packed = pool.map(
            lambda it: (it[0], encode_item(root, it[2], it[1], it[0],
                                           quality, resize, center_crop)),
            items)
        for idx, blob in packed:
            writer.write_idx(idx, blob)
    writer.close()
    print("wrote %s.rec (%d records)" % (prefix, len(items)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("prefix")
    ap.add_argument("root")
    ap.add_argument("--list", action="store_true",
                    help="generate prefix.lst from the image directory")
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--num-thread", type=int, default=8)
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--resize", type=int, default=0,
                    help="resize shorter edge to this many pixels")
    ap.add_argument("--center-crop", action="store_true")
    ap.add_argument("--no-recursive", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    require_device(args.device)
    if args.list:
        items = list_images(args.root, recursive=not args.no_recursive)
        write_list(args.prefix, items, shuffle=args.shuffle)
        print("wrote %s.lst (%d images)" % (args.prefix, len(items)))
    else:
        if not os.path.exists(args.prefix + ".lst"):
            items = list_images(args.root,
                                recursive=not args.no_recursive)
            write_list(args.prefix, items, shuffle=args.shuffle)
        make_rec(args.prefix, args.root, num_thread=args.num_thread,
                 quality=args.quality, resize=args.resize,
                 center_crop=args.center_crop)
    return 0


if __name__ == "__main__":
    sys.exit(main())
