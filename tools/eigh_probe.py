#!/usr/bin/env python3
"""How far float32 `torch.linalg.eigh` (the port's `linalg_syevd`) sits
from float64, on the CPU and on the card, for chip_smoke.py phase 21a's
syevd input: 64 symmetric 128 x 128 matrices Q diag(w) Q^T with
eigenvalues 1..128 at least 0.5 apart. Prints, per device, the
eigenvectors' largest error up to sign and relative Frobenius error, the
eigenvalues' relative error, the residual |A V - V diag(w)| / max |A|,
and the call's device time on the card (chip_smoke.time_ms).

    python3 tools/eigh_probe.py          # from the repository root
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def spd(batch=64, n=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.linalg.qr(torch.randn(batch, n, n, generator=g))[0]
    w = torch.linspace(1.0, float(n), n) + torch.rand(batch, n,
                                                      generator=g) * 0.5
    a = q @ (w[:, :, None] * q.transpose(1, 2))
    return (a + a.transpose(1, 2)) / 2


def errors(a, dev):
    w32, v32 = torch.linalg.eigh(a.to(dev))
    w64, v64 = torch.linalg.eigh(a.double())
    v32, w32 = v32.cpu().double(), w32.cpu().double()
    d = v32 - v64 * torch.sign((v32 * v64).sum(-2, keepdim=True))
    r = a.double() @ v32 - v32 * w32[:, None, :]
    return {"vec_max_abs": float(d.abs().max()),
            "vec_rel_fro": float(d.norm() / v64.norm()),
            "w_rel": float((w32 - w64).abs().max() / w64.abs().max()),
            "residual_rel": float(r.abs().max() / a.abs().max())}


def main():
    a = spd()
    out = {"cpu": errors(a, "cpu")}
    if torch.cuda.is_available():
        import chip_smoke
        dev = torch.device("cuda", 0)
        out["cuda"] = errors(a, dev)
        ad = a.to(dev)
        out["cuda_ms"] = chip_smoke.time_ms(
            torch, lambda: torch.linalg.eigh(ad), n=5, sleep=False)
        out["card"] = chip_smoke.nvidia_smi()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
