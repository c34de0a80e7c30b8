"""Launch wrapper of the hand-written CUDA kernel `eps_affine`
(`repro_torch/csrc/eps_affine.cu`), the port of the Pallas kernel in
`repro/kernels/eps_affine/kernel.py`.

The wrapper validates everything the kernel assumes, allocates the three
outputs, launches on the current CUDA stream without synchronising,
raises if the launch was refused, and counts launches in
`eps_affine.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.checks import MAX_SMEM, cuda_device, expect


def eps_affine(F, w, b):
    """eps = F·w − b (n,) f32 with an fp32 accumulator, labels (n,) int8
    (eps ≥ 0 → +1) and the positive count, a () int32 tensor left on the
    device (reading it is the caller's sync, not the kernel's).

    F (n, d) f32 or bf16, w (d,) f32, b () f32, all contiguous on one CUDA
    device."""
    device = cuda_device(F)
    n, d = F.shape
    expect(F, "F", (torch.float32, torch.bfloat16), (n, d), device)
    expect(w, "w", torch.float32, (d,), device)
    expect(b, "b", torch.float32, (), device)
    if d == 0 or 4 * d > MAX_SMEM:
        raise ValueError(f"d={d} is outside the kernel's launch limits")
    eps = torch.empty(n, dtype=torch.float32, device=device)
    labels = torch.empty(n, dtype=torch.int8, device=device)
    count = torch.empty((), dtype=torch.int32, device=device)
    lib = load("eps_affine")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.eps_affine(
            F.data_ptr(), w.data_ptr(), b.data_ptr(), eps.data_ptr(),
            labels.data_ptr(), count.data_ptr(), n, d,
            int(F.dtype == torch.bfloat16), stream)
    if err:
        msg = lib.eps_affine_error_string(err).decode()
        raise RuntimeError(f"eps_affine launch failed: {msg} ({err})")
    eps_affine.launches += 1
    return eps, labels, count


eps_affine.launches = 0
