"""Reconstruction and latent-class losses in plain PyTorch.

Counterpart of ``kindergarten_vq_vae_tpu/train/losses.py``:
``kl_recon_loss`` (l.30-73): the reference's ``kl_div(log_softmax, one_hot,
batchmean)``, i.e. the mean token NLL over the valid rows, with the JAX
package's custom VJP (``softmax - one_hot`` from the stored logsumexp,
scaled by ``g / denom * valid``, in the logits' dtype). The training step
takes it when ``fused_ce`` is off; with it on, ``ops/ce.fused_ce_loss_ids``.
``kl_onehot_loss`` (l.76-89): the Shelgon and Shelgon2 latent-class loss,
in f32 under autograd.
"""

from __future__ import annotations

import torch


class _KLRecon(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target_ids, valid_row):
        x = logits.float()
        m = x.amax(-1, keepdim=True)
        lse = (m + torch.log(torch.exp(x - m).sum(-1, keepdim=True)))[..., 0]
        tl = logits.gather(-1, target_ids.long()[..., None])[..., 0].float()
        w = valid_row.float()[:, None]
        denom = torch.clamp(w.sum(), min=1.0) * logits.shape[1]
        ctx.save_for_backward(logits, target_ids, lse, w, denom)
        return ((lse - tl) * w).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, target_ids, lse, w, denom = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        p.scatter_add_(-1, target_ids.long()[..., None],
                       torch.full(target_ids.shape + (1,), -1.0, device=p.device))
        return (p * ((g / denom) * w)[..., None]).to(logits.dtype), None, None


def kl_recon_loss(logits, target_ids, valid_row) -> torch.Tensor:
    """(B, S, V) logits vs (B, S) int targets and (B,) 1/0 valid rows -> scalar mean NLL."""
    return _KLRecon.apply(logits, target_ids, valid_row)


def kl_onehot_loss(logits, one_hot_target, valid_row) -> torch.Tensor:
    """KL(one_hot || softmax(logits)), batchmean over the valid rows, in f32:
    (B, R, C) logits and one-hot targets, (B,) 1/0 valid rows -> scalar."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    per_row = -torch.sum(one_hot_target.float() * logp, dim=-1)  # (B, R)
    w = valid_row.float()[:, None]
    denom = torch.clamp(w.sum(), min=1.0) * per_row.shape[1]
    return torch.sum(per_row * w) / denom
