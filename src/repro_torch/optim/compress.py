"""Gradient compression for the data-parallel all-reduce:
``repro/optim/compress.py``.

A full-precision all-reduce is a reduce-scatter and an all-gather. After
the (exact) reduce-scatter every rank holds its final slice, so the
all-gather half tolerates quantization: ``compressed_psum_mean`` does

    reduce-scatter fp32 -> int8-quantize (per-chunk scale) -> all-gather
    -> dequantize

over an ``AxisGroup`` (``sharding/spec.py``). As in ``repro``, the train
step does not call it (``TrainConfig.grad_compression`` is read nowhere).
The quantizer is ``repro``'s bit for bit: the same scale with its
``+1e-12`` and round-half-to-even (``torch.round`` as ``jnp.round``).
"""
from __future__ import annotations

import torch

CHUNK = 256  # elements per quantization scale


def quantize_int8(x: torch.Tensor):
    """x: flat float32 (N,) with N % CHUNK == 0. Returns (int8 (N,), scales
    (N / CHUNK,))."""
    xc = x.reshape(-1, CHUNK)
    scale = xc.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xc / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.reshape(-1, CHUNK).float() * scale[:, None]).reshape(-1)


def compressed_psum_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (an ``AxisGroup``, or a
    ``(mesh, axis)`` pair) with an int8 all-gather half. x: flat float32,
    of a length divisible by p * CHUNK."""
    from repro_torch.sharding.spec import as_axis_group

    group = as_axis_group(group)
    p = group.size
    part = group.reduce_scatter(x) / p
    q, s = quantize_int8(part)
    return dequantize_int8(group.all_gather(q).reshape(-1), group.all_gather(s).reshape(-1))
