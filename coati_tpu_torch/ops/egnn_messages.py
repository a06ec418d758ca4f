"""Fused EGNN message aggregation, plain PyTorch.

The plain versions of the port's message kernels, forward and backward
(ops/kernels/egnn_messages.py): the kernel wrapper runs them for CPU
tensors, and the tests and chip_smoke.py hold the kernels against them. The
function is
that of coati_tpu/ops/pallas/egnn_messages.py (egnn_messages_reference):

    mi[b, i] = sum_j w[b, i, j] * silu( silu(a[b, i] + c[b, j]
                                             + d2[b, i, j] * wd + b1) @ w2 + b2 )

the two-layer edge MLP of an e_gcl layer, its first layer already split by
the caller into a = h @ W1_i and c = h @ W1_j, with the cutoff and pair
mask `w` folded into the sum over partners j.

It materializes the (B, N, N, Hm) pairwise tensors (4.3 GB each in
float32 at B 1024, N 64, Hm 256), so it walks the batch in chunks. The
forward is differentiable by autograd; `egnn_messages_backward` is the same
gradient written out, with the rounding points of the TPU backward kernel.
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


def _dsilu(x: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def egnn_messages_backward(
    a: torch.Tensor,
    c: torch.Tensor,
    d2: torch.Tensor,
    w: torch.Tensor,
    wd: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    g: torch.Tensor,  # (B, N, Hm) cotangent of the messages
    mm_dtype: torch.dtype = torch.float32,
    chunk_bytes: int = CHUNK_BYTES,
):
    """-> (da, dc, dwd, db1, dw2, db2) in float32; d2 and w get no gradient.
    The formulas of coati_tpu's backward kernel (ops/pallas/egnn_messages.py,
    _bwd_kernel), which recomputes z1, e1, z2 per pair:

        dm  = w * g_i             dz2 = dm * silu'(z2)
        de1 = dz2 @ w2^T          dz1 = de1 * silu'(z1)
        da = sum_j dz1   dc = sum_i dz1   dwd = sum dz1 * d2   db1 = sum dz1
        dw2 = e1^T @ dz2          db2 = sum dz2

    mm_dtype bfloat16 rounds e1, w2 and dz2 to bf16 before each of the three
    products (z2, de1, dw2), which accumulate in float32; the sums for db2
    take the unrounded dz2."""
    if mm_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mm_dtype must be float32 or bfloat16, got {mm_dtype}")
    b, n, hm = a.shape
    af, cf, d2f, wf, gf = a.float(), c.float(), d2.float(), w.float(), g.float()
    wdf, b1f, w2f, b2f = wd.float(), b1.float(), w2.float(), b2.float()

    def mm_round(x):
        return x.to(torch.bfloat16).float() if mm_dtype == torch.bfloat16 else x

    w2f = mm_round(w2f)
    da, dc = torch.empty_like(af), torch.empty_like(cf)
    dwd, db1, db2 = (torch.zeros(hm, dtype=torch.float32, device=a.device) for _ in range(3))
    dw2 = torch.zeros(hm, hm, dtype=torch.float32, device=a.device)
    chunk = max(1, chunk_bytes // (4 * n * n * hm))
    for s in range(0, b, chunk):
        r = slice(s, s + chunk)
        z1 = af[r, :, None, :] + cf[r, None, :, :] + d2f[r][..., None] * wdf + b1f
        e1 = mm_round(F.silu(z1))
        z2 = e1 @ w2f + b2f
        dz2 = (wf[r][..., None] * gf[r][:, :, None, :]) * _dsilu(z2)
        del z2
        db2 += dz2.sum(dim=(0, 1, 2))
        dz2 = mm_round(dz2)
        dw2 += e1.reshape(-1, hm).t() @ dz2.reshape(-1, hm)
        del e1
        dz1 = (dz2 @ w2f.t()) * _dsilu(z1)
        del z1, dz2
        db1 += dz1.sum(dim=(0, 1, 2))
        dwd += (dz1 * d2f[r][..., None]).sum(dim=(0, 1, 2))
        da[r] = dz1.sum(dim=2)
        dc[r] = dz1.sum(dim=1)
    return da, dc, dwd, db1, dw2, db2
