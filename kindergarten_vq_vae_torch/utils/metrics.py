"""Sequence and codebook metrics in plain PyTorch.

Counterpart of ``kindergarten_vq_vae_tpu/utils/metrics.py``: ``seq_acc``
(l.15-28) counts padding positions as matches, as the reference metric does;
``padding_tokens_pct`` (l.62) and ``perplexity_from_counts`` (l.55).
"""

from __future__ import annotations

import torch


def seq_acc(recon_ids: torch.Tensor, target_ids: torch.Tensor):
    """Token accuracy: ``(acc_per_batch, acc_per_sentence)``; padding counts as correct."""
    if recon_ids.shape != target_ids.shape:
        raise ValueError("input and target shapes must match")
    match = (recon_ids.long() == target_ids.long()).float()
    return match.mean(), match.mean(-1)


def perplexity_from_counts(counts: torch.Tensor, total) -> torch.Tensor:
    """exp(-sum p log p) of per-code counts over ``total`` assignments (an
    int, or a tensor on the counts' device)."""
    total = torch.clamp(total, min=1) if isinstance(total, torch.Tensor) else max(total, 1)
    e_mean = counts.float() / total
    return torch.exp(-torch.sum(e_mean * torch.log(e_mean + 1e-10)))


def padding_tokens_pct(input_ids: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """Mean % of padding tokens per sentence."""
    mask = (input_ids == pad_id).float()
    return (mask.sum(-1) / mask.shape[-1] * 100.0).mean()
