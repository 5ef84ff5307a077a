"""Post-hoc analyses of a run directory, in PyTorch: the twin of
``kindergarten_vq_vae_tpu/analyses`` for the models the port has (Bagon and
Shelgon3-VQ). Nothing here imports pandas or matplotlib at import time."""

from kindergarten_vq_vae_torch.analyses.arithmetic import latent_arithmetic_bagon
from kindergarten_vq_vae_torch.analyses.common import batched_apply, load_run
from kindergarten_vq_vae_torch.analyses.cross_attention import (
    extract_cross_attention,
    plot_cross_attention,
)
from kindergarten_vq_vae_torch.analyses.disentanglement import unsupervised_vq_disentanglement
from kindergarten_vq_vae_torch.analyses.latent_space import (
    compute_sentence_latents,
    latent_space_visualization,
)
from kindergarten_vq_vae_torch.analyses.max_acc import get_max_acc_sentences

__all__ = ["batched_apply", "compute_sentence_latents", "extract_cross_attention",
           "get_max_acc_sentences", "latent_arithmetic_bagon", "latent_space_visualization",
           "load_run", "plot_cross_attention", "unsupervised_vq_disentanglement"]
