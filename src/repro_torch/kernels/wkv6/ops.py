"""Public wrapper of the WKV6 recurrence in the model layout
(b, s, H, K): a CUDA tensor goes to the hand-written kernel (or raises),
a CPU tensor to the plain PyTorch version, any other device raises. The
TPU wrapper padded s to the chunk and transposed to (b, H, s, K); the CUDA
kernel reads the model layout through its strides, and its tile loads fill
a ragged last chunk with zeros, so nothing is copied but the cast to f32.
The kernel has no backward yet: on CUDA a call under autograd with an
input that requires grad raises instead of returning an output without a
gradient; the plain version on the CPU runs under autograd."""
from __future__ import annotations

from repro_torch.kernels.checks import check_no_grad
from repro_torch.kernels.wkv6 import kernel
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref


def wkv6(r, k, v, la, u, *, chunk: int = 64):
    """r/k/v/la (b, s, H, K), any float dtype; u (H, K). Returns
    (b, s, H, K) f32 from a zero state, chunks of min(chunk, s) tokens
    from position 0. The recurrence runs in f32 whatever the input dtype,
    as the reference's wrapper casts (a no-op for the model's f32
    inputs)."""
    r, k, v, la, u = (t.float() for t in (r, k, v, la, u))
    dev = r.device
    if dev.type == "cuda":
        check_no_grad("wkv6", r, k, v, la, u)
        return kernel.wkv6(r, k, v, la, u.contiguous(), chunk=chunk)
    if dev.type == "cpu":
        return wkv6_chunked_ref(r, k, v, la, u, chunk)[0]
    raise ValueError(f"no wkv6 for device {dev}")
