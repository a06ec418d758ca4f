"""Fused EGNN message aggregation, plain PyTorch.

The plain version of the port's message kernel
(ops/kernels/egnn_messages.py): the kernel wrapper runs it for CPU tensors,
and the tests and chip_smoke.py hold the kernel against it. The function is
that of coati_tpu/ops/pallas/egnn_messages.py (egnn_messages_reference):

    mi[b, i] = sum_j w[b, i, j] * silu( silu(a[b, i] + c[b, j]
                                             + d2[b, i, j] * wd + b1) @ w2 + b2 )

the two-layer edge MLP of an e_gcl layer, its first layer already split by
the caller into a = h @ W1_i and c = h @ W1_j, with the cutoff and pair
mask `w` folded into the sum over partners j.

It materializes the (B, N, N, Hm) pairwise tensors (4.3 GB each in
float32 at B 1024, N 64, Hm 256), so it walks the batch in chunks. It is
differentiable by autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# bytes one (chunk, N, N, Hm) float32 intermediate may take
CHUNK_BYTES = 256 * 2**20


def egnn_messages(
    a: torch.Tensor,  # (B, N, Hm)
    c: torch.Tensor,  # (B, N, Hm)
    d2: torch.Tensor,  # (B, N, N) squared distances
    w: torch.Tensor,  # (B, N, N) cutoff * pair mask
    wd: torch.Tensor,  # (Hm,)
    b1: torch.Tensor,  # (Hm,)
    w2: torch.Tensor,  # (Hm, Hm), z2 = e1 @ w2
    b2: torch.Tensor,  # (Hm,)
    mm_dtype: torch.dtype = torch.float32,
    chunk_bytes: int = CHUNK_BYTES,
) -> torch.Tensor:
    """-> (B, N, Hm) in a's dtype. Everything is computed in float32, as
    the kernel does; mm_dtype bfloat16 rounds the two inputs of the inner
    product (e1 and w2) to bf16 first, and the product still accumulates in
    float32."""
    if mm_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mm_dtype must be float32 or bfloat16, got {mm_dtype}")
    b, n, hm = a.shape
    af, cf, d2f, wf = a.float(), c.float(), d2.float(), w.float()
    wdf, b1f, w2f, b2f = wd.float(), b1.float(), w2.float(), b2.float()
    if mm_dtype == torch.bfloat16:
        w2f = w2f.to(torch.bfloat16).float()
    chunk = max(1, chunk_bytes // (4 * n * n * hm))
    out = []
    for s in range(0, b, chunk):
        r = slice(s, s + chunk)
        z1 = af[r, :, None, :] + cf[r, None, :, :] + d2f[r][..., None] * wdf + b1f
        e1 = F.silu(z1)
        if mm_dtype == torch.bfloat16:
            e1 = e1.to(torch.bfloat16).float()
        m = F.silu(e1 @ w2f + b2f)
        out.append(torch.einsum("bijh,bij->bih", m, wf[r]))
    return torch.cat(out).to(a.dtype)
