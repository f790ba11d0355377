"""Per-tensor k-means codebooks (``repro.core.codebook`` in the port).

``quantize(w, bits)`` -> (codebook (2^bits,), indices uint8/uint16): a
quantile initialisation followed by a few Lloyd iterations;
``dequantize`` reconstructs; ``quantized_bytes`` is the effective size
``w.size * bits/8 + 2^bits * 4``.  The compression pipeline uses it for
the leaf-value and threshold codebooks.

The result equals the JAX package's to the bit, because the encoded
stream stores the centroids and the JAX package and the port must encode
the same bytes.  Three things make it so:

* the quantile levels are ``jnp.linspace(0, 1, k)`` as XLA computes it in
  float32: ``i * (1 / (k - 1))`` with the last level exactly 1;
* the quantile interpolation is XLA's on the CPU, which contracts
  ``low * lw + high * hw`` into ``fma(high, hw, round(low * lw))``: the
  fused multiply-add is done exactly here, in float64 with the rounding
  error tracked, and rounded once to float32;
* the Lloyd sums are taken on the CPU with ``index_add_``, in element
  order, as XLA's CPU ``segment_sum`` takes them.

A card would sum with float atomics in no fixed order, so the codebook
(and the encoded bytes with it) could change from run to run: ``quantize``
therefore always runs on the CPU, whatever the input's device, and moves
its result to that device afterwards.  The tables it is used on are at
most a few thousand values.
"""

from __future__ import annotations

import numpy as np
import torch


def _levels(k: int) -> np.ndarray:
    """``jnp.linspace(0.0, 1.0, k)`` as XLA computes it in float32."""
    step = np.float32(1) / np.float32(k - 1)
    return np.append(np.arange(k - 1, dtype=np.float32) * step, np.float32(1))


def _fma_f32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` for float32 arrays, rounded once to float32.

    The product of two float32 values is exact in float64, and the float64
    sum ``s`` is exact up to its rounding error ``err`` (two-sum).  Rounding
    ``s`` to float32 gives the fused result except where ``s`` lies exactly
    halfway between two float32 values; there the sign of ``err`` decides.
    """
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    above = r.astype(np.float64) > s
    lo = np.where(above, np.nextafter(r, np.float32(-np.inf)), r)
    hi = np.where(above, r, np.nextafter(r, np.float32(np.inf)))
    halfway = s == (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    r = np.where(halfway & (err > 0), hi, r)
    return np.where(halfway & (err < 0), lo, r).astype(np.float32)


def _quantile(flat: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """``jnp.quantile(flat, qs)`` (linear method) for float32 data."""
    a = np.sort(flat, kind="stable")
    n = a.shape[0]
    q = qs * np.float32(n - 1)
    low = np.floor(q)
    high = np.ceil(q)
    hw = q - low
    lw = np.float32(1) - hw
    lo = a[np.clip(low, 0, n - 1).astype(np.int64)]
    hi = a[np.clip(high, 0, n - 1).astype(np.int64)]
    return _fma_f32(hi, hw, lo * lw)


def quantize(w, bits: int = 4, iters: int = 8):
    """Per-tensor codebook quantisation (Lloyd's algorithm on quantiles).

    ``w`` is a tensor on any device; returns ``(codebook (2**bits,)
    float32, indices)`` on ``w``'s device, the indices uint8 for
    ``bits <= 8`` and uint16 above, in ``w``'s shape.
    """
    if not 2 <= bits <= 16:
        raise ValueError(f"bits must be in [2, 16], got {bits}")
    flat = w.detach().cpu().reshape(-1).to(torch.float32).contiguous()
    k = 2**bits
    codebook = torch.from_numpy(_quantile(flat.numpy(), _levels(k)))
    ones = torch.ones_like(flat)

    def nearest(cb):
        return torch.argmin((flat[:, None] - cb[None, :]).abs(), dim=1)

    for _ in range(iters):
        idx = nearest(codebook)
        sums = torch.zeros(k, dtype=torch.float32).index_add_(0, idx, flat)
        cnts = torch.zeros(k, dtype=torch.float32).index_add_(0, idx, ones)
        codebook = torch.where(cnts > 0, sums / cnts.clamp(min=1), codebook)
    dtype = torch.uint8 if bits <= 8 else torch.uint16
    idx = nearest(codebook).to(dtype).reshape(w.shape)
    return codebook.to(w.device), idx.to(w.device)


def dequantize(codebook: torch.Tensor, indices: torch.Tensor, dtype=torch.bfloat16):
    return codebook[indices.to(torch.int64)].to(dtype)


def quantized_bytes(shape, bits: int) -> float:
    n = 1
    for s in shape:
        n *= s
    return n * bits / 8.0 + (2**bits) * 4.0
