"""Self-attention with torch ``nn.MultiheadAttention`` semantics
(batch_first=False, packed (3E, E) in-projection), written as plain matmuls
as in ``ops/attention.py:44-76``. The family-2 head runs it with one head
over a sequence of at most four stage Grams, so it is a handful of tiny
products; the batch carries the parallelism."""
from __future__ import annotations

import torch


def multihead_attention(
    x: torch.Tensor,
    in_proj_weight: torch.Tensor,
    in_proj_bias: torch.Tensor,
    out_proj_weight: torch.Tensor,
    out_proj_bias: torch.Tensor,
    num_heads: int = 1,
) -> torch.Tensor:
    """x: (L, N, E) -> (L, N, E)."""
    L, N, E = x.shape
    H = num_heads
    D = E // H
    qkv = torch.matmul(x, in_proj_weight.to(x.dtype).t()) + in_proj_bias.to(x.dtype)
    q, k, v = qkv.split(E, dim=-1)

    def heads(t):  # (L, N, E) -> (N, H, L, D)
        return t.reshape(L, N, H, D).permute(1, 2, 0, 3)

    q, k, v = heads(q), heads(k), heads(v)
    q = q * (D ** -0.5)
    logits = torch.matmul(q, k.transpose(-1, -2)).float()
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.matmul(probs, v).permute(2, 0, 1, 3).reshape(L, N, E)
    return torch.matmul(ctx, out_proj_weight.to(x.dtype).t()) + out_proj_bias.to(x.dtype)
