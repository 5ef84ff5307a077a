"""Read-only view of a run's ``run_conf.json``.

Counterpart of ``kindergarten_vq_vae_tpu/train/config.py`` (``RunConfig.load``
/ ``from_flat_dict``, l.269-312): the same flat snake_case schema, cut to the
fields the serving slice and the training step read (the ``OptimConfig``
fields of l.150-173 among them). Defaults equal the JAX package's, so a file
that omits a key means the same thing to both; unknown keys are ignored.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model_name: str = "bagon"
    decoder_model_name: str = "bert-base-uncased"
    model_mode: str = "full"
    vocab_size: int = 30522
    decoder_vocab_size: Optional[int] = None
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    tie_word_embeddings: bool = True
    gelu_exact: bool = True
    compute_dtype: str = "bfloat16"
    vq_mode: str = "VectorQuantizer"
    vq_n_e: int = 9
    vq_e_dim: int = 768
    vq_beta: float = 0.69
    vq_ema_update: bool = False
    vq_dead_code_threshold: int = 0
    fused_ce: bool = True
    data_dir: str = "./data/dSentences"
    tokenizer_file: str = "dSentences_tokenizer.json"
    tokenized_sentence_max_length: int = 12
    tokenizer_add_special_tokens: bool = True
    # optimizer (OptimConfig)
    lr: float = 1e-4
    weight_decay: float = 0.0
    amsgrad: bool = True
    fused_update: str = "auto"
    lr_scheduler: Optional[str] = None
    milestones: tuple = ()
    gamma: float = 0.1
    loss_recon_rescale_factor: float = 1.0
    loss_recon_weight: float = 1.0
    loss_vq_rescale_factor: float = 1.0
    loss_vq_weight: float = 1.0
    # input perturbation and the options the training step refuses
    encoder_perturb_train_pct: float = 0.0
    encoder_perturb_val_pct: float = 0.0
    encoder_perturb_test_pct: float = 0.0
    decoder_perturb_train_pct: float = 0.0
    decoder_perturb_val_pct: float = 0.0
    decoder_perturb_test_pct: float = 0.0
    wandb_watch_model: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @classmethod
    def from_flat_dict(cls, conf: dict) -> "RunConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in conf.items() if k in names}
        if isinstance(kw.get("milestones"), list):
            kw["milestones"] = tuple(kw["milestones"])
        return cls(**kw)

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as fp:
            return cls.from_flat_dict(json.load(fp))
