"""Public wrapper of decode attention in the model layout: a CUDA tensor
goes to the hand-written kernel (or raises), a CPU tensor to the plain
PyTorch version, any other device raises. The TPU grid streamed every
`block_s` block of the cache and masked it, and needed S % block_s == 0;
the CUDA kernel reads only rows 0..cache_index, of a cache of any S.
The kernel has no backward: on CUDA a call under autograd with an input
that requires grad raises instead of returning an output without a
gradient; the plain version on the CPU runs under autograd."""
from __future__ import annotations

import torch

from repro_torch.kernels.checks import check_no_grad
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


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


def decode_attention(q, k_cache, v_cache, cache_index: int):
    """q (b, 1, nq, hd); caches (b, S, nkv, hd) of q's dtype (f32 or
    bf16) or f8 e4m3fn; `cache_index` a host int (positions after it are
    masked). Returns (b, 1, nq, hd) in q's dtype. The reference's
    `block_s` has no counterpart: the CUDA kernel streams 64-row tiles of
    its own."""
    check_cache_dtype(q, k_cache, v_cache)
    b, _, nq, hd = q.shape
    nkv = k_cache.shape[2]
    qg = q.reshape(b, nkv, nq // nkv, hd)
    cache_index = int(cache_index)
    dev = q.device
    if dev.type == "cuda":
        check_no_grad("decode_attention", q, k_cache, v_cache)
        out = kernel.decode_attention(qg, k_cache, v_cache, cache_index)
    elif dev.type == "cpu":
        out = decode_attention_ref(qg, k_cache, v_cache, cache_index)
    else:
        raise ValueError(f"no decode_attention for device {dev}")
    return out.reshape(b, 1, nq, hd)
