"""Public wrapper of decode attention in the model layout: a CUDA tensor
goes to the hand-written kernel (or raises), a CPU tensor to the plain
PyTorch version, any other device raises. The TPU grid streamed every
`block_s` block of the cache and masked it, and needed S % block_s == 0;
the CUDA kernel reads only rows 0..cache_index, of a cache of any S.
The kernel has no backward: on CUDA a call under autograd with an input
that requires grad raises instead of returning an output without a
gradient; the plain version on the CPU runs under autograd. A `meta`
tensor launches nothing: the call returns empty meta outputs and records
its cost for the dry run (`kernels/dry.py`).

On a mesh whose cache is split over its rows the call takes one rank's
block (`row0`, the global row of its first) and returns the logsumexp
beside the output (`with_lse`), by which the ranks' partial outputs are
combined."""
from __future__ import annotations

import torch

from repro_torch.kernels import dry
from repro_torch.kernels.checks import check_no_grad, served_device
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_block_ref, decode_attention_ref)


def check_cache_dtype(q, k_cache, v_cache):
    """Raise unless the caches share a dtype that is q's or, for a q of
    f32 or bf16, f8 e4m3fn (the one 8-bit cache either device reads)."""
    kd = k_cache.dtype
    if v_cache.dtype != kd:
        raise TypeError(f"k cache {kd} and v cache {v_cache.dtype} differ")
    if kd == kernel.F8:
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"an f8 cache takes an f32 or bf16 q, got "
                            f"{q.dtype}")
    elif kd.itemsize == 1 or kd != q.dtype:
        raise TypeError(f"a cache of {kd} with q of {q.dtype}: the cache "
                        f"is q's dtype or float8_e4m3fn")


def decode_attention(q, k_cache, v_cache, cache_index: int, *,
                     row0=None, with_lse: bool = False):
    """q (b, 1, nq, hd); caches (b, S, nkv, hd) of q's dtype (f32 or
    bf16) or f8 e4m3fn; `cache_index` a host int (positions after it are
    masked). Returns (b, 1, nq, hd) in q's dtype. The reference's
    `block_s` has no counterpart: the CUDA kernel streams 64-row tiles of
    its own. With `row0` the caches are the block of global rows [row0,
    row0 + S) of a longer cache; with `with_lse` the call returns (out,
    lse (b, nq) f32), lse the logsumexp of each head's scaled logits over
    the rows attended (−inf, and out 0, where there are none)."""
    kind = served_device(q, "decode_attention")
    check_cache_dtype(q, k_cache, v_cache)
    b, _, nq, hd = q.shape
    nkv = k_cache.shape[2]
    qg = q.reshape(b, nkv, nq // nkv, hd)
    cache_index = int(cache_index)
    dev = q.device
    lse = None
    if kind == "meta":
        S = k_cache.shape[1]
        n = (cache_index + 1 if row0 is None
             else min(cache_index - row0 + 1, S))
        if n > 0:
            dry.record("decode_attention", kernel.decode_attention_cost(
                b, nkv, nq // nkv, hd, n, q.element_size(),
                k_cache.element_size(), lse=with_lse))
        out = torch.empty_like(qg)
        lse = torch.empty(qg.shape[:3], dtype=torch.float32, device=dev)
    elif kind == "cuda":
        check_no_grad("decode_attention", q, k_cache, v_cache)
        out = kernel.decode_attention(qg, k_cache, v_cache, cache_index,
                                      with_lse=with_lse, row0=row0)
        if with_lse:
            out, lse = out
    elif row0 is None and not with_lse:
        out = decode_attention_ref(qg, k_cache, v_cache, cache_index)
    else:
        out, lse = decode_attention_block_ref(qg, k_cache, v_cache,
                                              cache_index, row0 or 0)
    out = out.reshape(b, 1, nq, hd)
    return (out, lse.reshape(b, nq)) if with_lse else out
