"""Gumbel-softmax sampling and the Gumbel codebook quantizer, in plain PyTorch.

Counterpart of ``kindergarten_vq_vae_tpu/ops/gumbel.py``:

- :func:`gumbel_softmax_with` (l.24-37): ``softmax((logits + gumbels) / tau)``
  along ``dim``; ``hard=True`` gives JAX's own expression
  ``y_soft + stop_gradient(y_hard - y_soft)`` (``y_hard`` the one-hot of the
  first maximum), so the forward bits are that sum and not ``y_hard``;
- :func:`gumbel_quantize` (l.47-81): the k=1 Conv1d projection as a dense
  (logits (B, n_embed, S)), the Gumbel softmax over the code axis (forced
  hard outside training, l.70), the codebook mix-in, the KL-to-uniform
  regulariser and the argmax indices;
- :func:`unique_count_perplexity` (l.84-89): the number of distinct codes
  used, on the device.

JAX draws the noise with ``jax.random.gumbel`` in the logits' dtype; the
port draws it in :func:`sample_gumbels` from a :class:`torch.Generator`
(``-log`` of a unit exponential, as ``torch.nn.functional.gumbel_softmax``
does), so the two streams differ while the distribution is the same; under
a device mesh the noise is the rank's rows of a draw at the global batch's
shape. The
arithmetic after the draw takes the noise as an argument, which is how the
tests hold it against JAX given JAX's noise. None of these functions is a
Pallas kernel in JAX; the models run them in f32, as the JAX modules'
dtype-less ``nn.Dense`` promote the bf16 encoder output to f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kindergarten_vq_vae_torch.parallel.mesh import dp_sum, global_draw


class GumbelFeed:
    """Gumbel noise handed in where a generator is expected: each
    :func:`sample_gumbels` call takes the next tensor of ``noise``, which
    must have the draw's shape and dtype. With ``noise=None`` the feed
    records each draw's ``(shape, dtype)`` in ``specs`` and hands out zeros.
    The exported serving program (``serve/export.py``) takes its noise as
    inputs so, since a trace cannot carry a generator."""

    def __init__(self, noise=None):
        self.noise = None if noise is None else list(noise)
        self.specs: list[tuple[tuple[int, ...], torch.dtype]] = []

    def take(self, like: torch.Tensor) -> torch.Tensor:
        spec = (tuple(like.shape), like.dtype)
        i = len(self.specs)
        self.specs.append(spec)
        if self.noise is None:
            return torch.zeros(like.shape, dtype=like.dtype, device=like.device)
        if i >= len(self.noise):
            raise ValueError(f"the forward asks for Gumbel draw {i + 1}; {len(self.noise)} fed")
        g = self.noise[i]
        if (tuple(g.shape), g.dtype) != spec:
            raise ValueError(f"Gumbel draw {i + 1} is {spec}; fed {(tuple(g.shape), g.dtype)}")
        return g


def sample_gumbels(like: torch.Tensor, generator: torch.Generator | GumbelFeed) -> torch.Tensor:
    """Standard Gumbel noise of ``like``'s shape, dtype and device, drawn from
    ``generator`` (on that device), or the next tensor of a :class:`GumbelFeed`."""
    if generator is None:
        raise ValueError("Gumbel noise needs a torch.Generator")
    if isinstance(generator, GumbelFeed):
        return generator.take(like)
    return global_draw(like.shape, lambda shape: -torch.empty(
        shape, dtype=like.dtype, device=like.device).exponential_(generator=generator).log())


def gumbel_softmax_with(logits: torch.Tensor, gumbels: torch.Tensor, tau: float = 1.0,
                        hard: bool = False, dim: int = -1) -> torch.Tensor:
    """The Gumbel softmax of ``logits`` given the noise ``gumbels``."""
    y_soft = torch.softmax((logits + gumbels) / tau, dim=dim)
    if not hard:
        return y_soft
    index = torch.argmax(y_soft, dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
    return y_soft + (y_hard - y_soft).detach()


def gumbel_softmax(logits: torch.Tensor, tau: float = 1.0, hard: bool = False, dim: int = -1,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """:func:`gumbel_softmax_with` on noise drawn from ``generator``."""
    return gumbel_softmax_with(logits, sample_gumbels(logits, generator), tau, hard, dim)


class GumbelQuantizeOutput(NamedTuple):
    z_q: torch.Tensor  # (B, S, D)
    diff: torch.Tensor  # scalar KL-to-uniform regulariser
    indices: torch.Tensor  # (B, S) code indices
    soft_one_hot: torch.Tensor  # (B, n_embed, S)


def gumbel_quantize(z: torch.Tensor, proj_kernel: torch.Tensor, proj_bias: torch.Tensor,
                    codebook: torch.Tensor, temperature: float, kl_div_scale: float,
                    straight_through: bool, is_training: bool,
                    generator: torch.Generator | None = None) -> GumbelQuantizeOutput:
    """``z`` (B, S, E), ``proj_kernel`` (E, n_embed), ``proj_bias`` (n_embed,),
    ``codebook`` (n_embed, D); computed in ``z``'s dtype."""
    n_embed = codebook.shape[0]
    logits = torch.einsum("bse,en->bns", z, proj_kernel) + proj_bias[None, :, None]
    hard = straight_through if is_training else True
    soft_one_hot = gumbel_softmax(logits, temperature, hard, 1, generator)
    z_q = torch.einsum("bns,nd->bsd", soft_one_hot, codebook)
    qy = torch.softmax(logits, dim=1)
    diff = kl_div_scale * torch.mean(torch.sum(qy * torch.log(qy * n_embed + 1e-10), dim=1))
    indices = torch.argmax(soft_one_hot, dim=1)
    return GumbelQuantizeOutput(z_q, diff, indices, soft_one_hot)


def unique_count_perplexity(indices: torch.Tensor, n_embed: int) -> torch.Tensor:
    """The number of distinct codes in ``indices``, as an f32 scalar (the
    reference's Gumbel "perplexity" proxy), with no host sync; under a
    device mesh the codes of every dp rank's rows."""
    flat = indices.reshape(-1)
    counts = torch.zeros(n_embed, dtype=torch.float32, device=indices.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    (counts,) = dp_sum(counts)
    return torch.sum(counts > 0).float()
