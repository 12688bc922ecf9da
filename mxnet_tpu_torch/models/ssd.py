"""SSDLite, the compact SSD detector of BASELINE config 4 (port of
`mxnet_tpu/models/ssd.py`): a small conv backbone (two conv-BN-ReLU-pool
stages), three strided conv-BN-ReLU blocks, each with a class head, a box
head and its MultiBoxPrior anchors; `targets` runs MultiBoxTarget with
hard-negative mining and `detect` MultiBoxDetection. Its five BatchNorms
take the fused BatchNorm kernels (K3a-d) when training with
MXNET_FUSED_BN_EPILOGUE=1.
"""
from __future__ import annotations

from ..gluon import nn, HybridBlock
from .. import ndarray as F


class SSDLite(HybridBlock):
    """Compact SSD: 3 feature scales, the full multibox pipeline."""

    def __init__(self, num_classes=20, sizes=((0.2,), (0.4,), (0.7,)),
                 ratios=((1.0, 2.0, 0.5),) * 3, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.sizes = sizes
        self.ratios = ratios
        self._anchors_per_cell = [len(s) + len(r) - 1
                                  for s, r in zip(sizes, ratios)]
        with self.name_scope():
            self.stem = nn.HybridSequential(prefix="stem_")
            for ch in (32, 64):
                self.stem.add(nn.Conv2D(ch, 3, padding=1, use_bias=False))
                self.stem.add(nn.BatchNorm())
                self.stem.add(nn.Activation("relu"))
                self.stem.add(nn.MaxPool2D(2))
            self.blocks = []
            self.cls_heads = []
            self.loc_heads = []
            for i, a in enumerate(self._anchors_per_cell):
                blk = nn.HybridSequential(prefix="blk%d_" % i)
                blk.add(nn.Conv2D(64, 3, strides=2, padding=1,
                                  use_bias=False))
                blk.add(nn.BatchNorm())
                blk.add(nn.Activation("relu"))
                cls = nn.Conv2D(a * (num_classes + 1), 3, padding=1,
                                prefix="cls%d_" % i)
                loc = nn.Conv2D(a * 4, 3, padding=1, prefix="loc%d_" % i)
                self.blocks.append(blk)
                self.cls_heads.append(cls)
                self.loc_heads.append(loc)
                setattr(self, "blk%d" % i, blk)
                setattr(self, "cls%d" % i, cls)
                setattr(self, "loc%d" % i, loc)

    def forward(self, x):
        """Returns (anchors [1,A,4], cls_preds [N,C+1,A], loc_preds [N,A*4])."""
        feats = self.stem(x)
        anchors, cls_preds, loc_preds = [], [], []
        for i, blk in enumerate(self.blocks):
            feats = blk(feats)
            anchors.append(F.contrib.MultiBoxPrior(
                feats, sizes=self.sizes[i], ratios=self.ratios[i]))
            c = self.cls_heads[i](feats)
            n = c.shape[0]
            cls_preds.append(
                c.transpose((0, 2, 3, 1)).reshape(
                    (n, -1, self.num_classes + 1)))
            l = self.loc_heads[i](feats)
            loc_preds.append(l.transpose((0, 2, 3, 1)).reshape((n, -1)))
        anchors = F.Concat(*anchors, dim=1)
        cls_preds = F.Concat(*cls_preds, dim=1).transpose((0, 2, 1))
        loc_preds = F.Concat(*loc_preds, dim=1)
        return anchors, cls_preds, loc_preds

    def targets(self, anchors, labels, cls_preds):
        """Training targets via MultiBoxTarget."""
        return F.contrib.MultiBoxTarget(anchors, labels, cls_preds,
                                        overlap_threshold=0.5,
                                        negative_mining_ratio=3.0)

    def detect(self, cls_preds, loc_preds, anchors, nms_threshold=0.45):
        probs = F.softmax(cls_preds, axis=1)
        return F.contrib.MultiBoxDetection(probs, loc_preds, anchors,
                                           nms_threshold=nms_threshold)
