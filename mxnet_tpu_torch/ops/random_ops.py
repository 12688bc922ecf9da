"""Random sampling ops (port of `mxnet_tpu/ops/random_ops.py`).

Each op draws from the generator of the device it samples on
(`mxnet_tpu_torch.random.generator`). The `_random_*` ops take scalar
parameters and are creation ops (registry.py): they sample on the device
their caller passes as `device=` (the NDArray call's context, a bound
Symbol's executor device), and on the "meta" device of Symbol shape
inference they give an empty tensor of the sample's shape and draw
nothing. The `_sample_*` ops draw one sample array per element of their
parameter tensors, on the parameters' device (parity: the reference's
multisample_op.h). torch and jax.random give different numbers from one
seed, so the port matches the reference in distribution, not bit for
bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import torch_dtype
from ..random import generator
from .registry import register


def _shp(shape):
    if shape is None:
        return ()
    if np.isscalar(shape):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _shape_only(device, shape, dtype):
    """An empty tensor of the sample's shape when shape inference calls
    the op on the "meta" device (no generator is touched), else None."""
    if torch.device(device).type != "meta":
        return None
    return torch.empty(_shp(shape), dtype=torch_dtype(dtype), device="meta")


@register("_random_uniform", differentiable=False, stochastic=True,
          creation=True, aliases=("uniform",))
def _random_uniform(low=0.0, high=1.0, shape=None, dtype="float32",
                    device=None):
    empty = _shape_only(device, shape, dtype)
    if empty is not None:
        return empty
    dev = torch.device(device)
    u = torch.rand(_shp(shape), generator=generator(dev), device=dev,
                   dtype=torch_dtype(dtype))
    return low + u * (high - low)


@register("_random_normal", differentiable=False, stochastic=True,
          creation=True, aliases=("normal",))
def _random_normal(loc=0.0, scale=1.0, shape=None, dtype="float32",
                   device=None):
    empty = _shape_only(device, shape, dtype)
    if empty is not None:
        return empty
    dev = torch.device(device)
    return loc + scale * torch.randn(_shp(shape), generator=generator(dev),
                                     device=dev, dtype=torch_dtype(dtype))


@register("_random_gamma", differentiable=False, stochastic=True,
          creation=True)
def _random_gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32",
                  device=None):
    empty = _shape_only(device, shape, dtype)
    if empty is not None:
        return empty
    dev = torch.device(device)
    a = torch.full(_shp(shape), float(alpha), device=dev)
    g = torch._standard_gamma(a, generator=generator(dev))
    return (beta * g).to(torch_dtype(dtype))


@register("_random_exponential", differentiable=False, stochastic=True,
          creation=True, aliases=("exponential",))
def _random_exponential(lam=1.0, shape=None, dtype="float32", device=None):
    empty = _shape_only(device, shape, dtype)
    if empty is not None:
        return empty
    dev = torch.device(device)
    e = torch.empty(_shp(shape), device=dev, dtype=torch_dtype(dtype))
    return e.exponential_(1.0, generator=generator(dev)) / lam


@register("_random_poisson", differentiable=False, stochastic=True,
          creation=True, aliases=("poisson",))
def _random_poisson(lam=1.0, shape=None, dtype="float32", device=None):
    empty = _shape_only(device, shape, dtype)
    if empty is not None:
        return empty
    dev = torch.device(device)
    rate = torch.full(_shp(shape), float(lam), device=dev)
    return torch.poisson(rate, generator=generator(dev)).to(
        torch_dtype(dtype))


@register("_random_negative_binomial", differentiable=False, stochastic=True,
          creation=True, aliases=("negative_binomial",))
def _random_negative_binomial(k=1, p=1.0, shape=None, dtype="float32",
                              device=None):
    empty = _shape_only(device, shape, dtype)
    if empty is not None:
        return empty
    dev = torch.device(device)
    gen = generator(dev)
    a = torch.full(_shp(shape), float(k), device=dev)
    lam = torch._standard_gamma(a, generator=gen) * (1 - p) / p
    return torch.poisson(lam, generator=gen).to(torch_dtype(dtype))


@register("_random_generalized_negative_binomial", differentiable=False,
          stochastic=True, creation=True,
          aliases=("generalized_negative_binomial",))
def _random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                          dtype="float32", device=None):
    empty = _shape_only(device, shape, dtype)
    if empty is not None:
        return empty
    dev = torch.device(device)
    gen = generator(dev)
    if alpha == 0.0:
        rate = torch.full(_shp(shape), float(mu), device=dev)
        return torch.poisson(rate, generator=gen).to(torch_dtype(dtype))
    r = 1.0 / alpha
    p = r / (r + mu)
    a = torch.full(_shp(shape), r, device=dev)
    lam = torch._standard_gamma(a, generator=gen) * (1 - p) / p
    return torch.poisson(lam, generator=gen).to(torch_dtype(dtype))


@register("_random_randint", differentiable=False, stochastic=True,
          creation=True)
def _random_randint(low=0, high=1, shape=None, dtype="int32", device=None):
    empty = _shape_only(device, shape, dtype)
    if empty is not None:
        return empty
    dev = torch.device(device)
    return torch.randint(int(low), int(high), _shp(shape),
                         generator=generator(dev), device=dev,
                         dtype=torch_dtype(dtype))


# _sample_* variants: one draw per element of the parameter tensors


def _bcast(param, s):
    """param [*P] viewed as [*P, 1, ...] against sample shape s."""
    return param.reshape(tuple(param.shape) + (1,) * len(s))


@register("_sample_uniform", differentiable=False, stochastic=True)
def _sample_uniform(low, high, shape=None, dtype=None):
    s = _shp(shape)
    u = torch.rand(tuple(low.shape) + s, generator=generator(low.device),
                   device=low.device, dtype=low.dtype)
    return _bcast(low, s) + u * (_bcast(high, s) - _bcast(low, s))


@register("_sample_normal", differentiable=False, stochastic=True)
def _sample_normal(mu, sigma, shape=None, dtype=None):
    s = _shp(shape)
    z = torch.randn(tuple(mu.shape) + s, generator=generator(mu.device),
                    device=mu.device, dtype=mu.dtype)
    return _bcast(mu, s) + _bcast(sigma, s) * z


@register("_sample_gamma", differentiable=False, stochastic=True)
def _sample_gamma(alpha, beta, shape=None, dtype=None):
    s = _shp(shape)
    a = _bcast(alpha, s).expand(tuple(alpha.shape) + s).float()
    g = torch._standard_gamma(a.contiguous(),
                              generator=generator(alpha.device))
    g = g.to(alpha.dtype)
    return g * _bcast(beta, s)


@register("_sample_exponential", differentiable=False, stochastic=True)
def _sample_exponential(lam, shape=None, dtype=None):
    s = _shp(shape)
    e = torch.empty(tuple(lam.shape) + s, device=lam.device, dtype=lam.dtype)
    e.exponential_(1.0, generator=generator(lam.device))
    return e / _bcast(lam, s)


@register("_sample_poisson", differentiable=False, stochastic=True)
def _sample_poisson(lam, shape=None, dtype=None):
    s = _shp(shape)
    rate = _bcast(lam, s).expand(tuple(lam.shape) + s).float().contiguous()
    return torch.poisson(rate, generator=generator(lam.device)).to(lam.dtype)


@register("_sample_negative_binomial", differentiable=False, stochastic=True)
def _sample_negative_binomial(k, p, shape=None, dtype=None):
    """Per-element NB(k_i, p_i) draws via the gamma-Poisson mixture."""
    s = _shp(shape)
    full = tuple(k.shape) + s
    kb = _bcast(k, s).expand(full).float().contiguous()
    pb = _bcast(p, s).expand(full).float()
    gen = generator(k.device)
    lam = torch._standard_gamma(kb, generator=gen) * (1 - pb) / pb
    return torch.poisson(lam, generator=gen).to(
        torch_dtype(dtype or "float32"))


@register("_sample_generalized_negative_binomial", differentiable=False,
          stochastic=True)
def _sample_generalized_negative_binomial(mu, alpha, shape=None, dtype=None):
    """Per-element GNB(mu_i, alpha_i); alpha_i == 0 degenerates to
    Poisson(mu_i)."""
    s = _shp(shape)
    full = tuple(mu.shape) + s
    mub = _bcast(mu, s).expand(full).float()
    ab = _bcast(alpha, s).expand(full).float()
    r = 1.0 / torch.clamp(ab, min=1e-6)
    pgb = r / (r + mub)
    gen = generator(mu.device)
    lam = torch.where(ab <= 1e-6, mub,
                      torch._standard_gamma(r.contiguous(), generator=gen)
                      * (1 - pgb) / pgb)
    return torch.poisson(lam, generator=gen).to(
        torch_dtype(dtype or "float32"))


@register("_sample_multinomial", differentiable=False, stochastic=True)
def _sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """data: [..., K] probabilities; returns [..., *shape] class indices
    (and their log-probabilities with get_prob)."""
    s = _shp(shape) or ()
    n = int(np.prod(s)) if s else 1
    flat = data.reshape(-1, data.shape[-1]).float()
    draws = torch.multinomial(torch.clamp(flat, min=1e-37), n,
                              replacement=True,
                              generator=generator(data.device))  # [B, n]
    out = draws.reshape(tuple(data.shape[:-1]) + s).to(torch_dtype(dtype))
    if get_prob:
        logp = torch.gather(torch.log_softmax(torch.log(torch.clamp(
            flat, min=1e-37)), dim=-1), 1, draws).reshape(out.shape)
        return out, logp
    return out


@register("_shuffle", differentiable=False, stochastic=True)
def _shuffle(data):
    """Shuffle along the first axis (parity: shuffle_op.cc)."""
    perm = torch.randperm(data.shape[0], generator=generator(data.device),
                          device=data.device)
    return data[perm]


@register("_sample_unique_zipfian", differentiable=False, stochastic=True,
          creation=True)
def _sample_unique_zipfian(range_max=1, shape=None, device=None):
    """Approximately Zipfian draws: exp(u log(range_max + 1)) - 1, as the
    reference draws them."""
    empty = _shape_only(device, shape, "int64")
    if empty is not None:
        return empty
    dev = torch.device(device)
    u = torch.rand(_shp(shape), generator=generator(dev), device=dev)
    out = torch.exp(u * math.log(float(range_max) + 1.0)) - 1.0
    return torch.clamp(out.to(torch.int64), 0, range_max - 1)
