"""Public wrapper of decode attention in the model layout: a CUDA tensor
goes to the hand-written kernel (or raises), a CPU tensor to the plain
PyTorch version, any other device raises. The TPU grid streamed every
`block_s` block of the cache and masked it, and needed S % block_s == 0;
the CUDA kernel reads only rows 0..cache_index, of a cache of any S."""
from __future__ import annotations

from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k_cache, v_cache, cache_index: int):
    """q (b, 1, nq, hd); caches (b, S, nkv, hd), f32 or bf16;
    `cache_index` a host int (positions after it are masked). Returns
    (b, 1, nq, hd) in q's dtype. The reference's `block_s` has no
    counterpart: the CUDA kernel streams 64-row tiles of its own."""
    b, _, nq, hd = q.shape
    nkv = k_cache.shape[2]
    qg = q.reshape(b, nkv, nq // nkv, hd)
    cache_index = int(cache_index)
    dev = q.device
    if dev.type == "cuda":
        out = kernel.decode_attention(qg, k_cache, v_cache, cache_index)
    elif dev.type == "cpu":
        out = decode_attention_ref(qg, k_cache, v_cache, cache_index)
    else:
        raise ValueError(f"no decode_attention for device {dev}")
    return out.reshape(b, 1, nq, hd)
