"""The run configuration: the JAX package's flat ``run_conf.json`` schema.

Counterpart of ``kindergarten_vq_vae_tpu/train/config.py`` (l.19-312): every
field of its ``ModelConfig``, ``DataConfig``, ``OptimConfig`` and
``RunConfig``, in that order and with the same defaults, as one flat frozen
dataclass. ``get_config()`` gives the same flat dict (tuples as lists) and
``save()`` writes it as ``run_conf.json``, so a file written by either side
loads in the other; unknown keys are ignored on load.

``fused_layer`` and ``fused_attn`` choose the trunk's route
(``models/__init__.py`` ``bert_configs``): "auto" and "on" the whole-layer
kernels, "off" the per-module layers, whose attention core is the SDPA
kernels (#11 / #12) unless ``fused_attn`` is "off". Fields that choose a
TPU implementation rather than a function are read and ignored:
``vq_use_fused``, ``remat``, ``rng_impl`` and the tile sizes
(``sdpa_block_b``, ``layer_block_b_*``, ``layer_attn_chunk*``,
``head_ce_block_*``). On CUDA the layers (on either route), the VQ and the
CE always run as the port's kernels, in bf16 only. A ``decoder_model_name``
holding "gpt" selects the GPT-2 decoder (``nn/gpt2.py``). The fields of a
device mesh, which the port does not have yet, are carried so the schema
stays whole; :func:`refuse_unported` raises on them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

_TUPLES = ("milestones", "mesh_shape", "mesh_axis_names", "ckpt_slots")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    # ---- ModelConfig
    model_name: str = "bagon"  # bagon | shelgon | shelgon2 | shelgon3
    encoder_model_name: str = "bert-base-uncased"
    decoder_model_name: str = "bert-base-uncased"
    model_mode: str = "full"  # full | dec-head-ft | enc-head-ft-dec-head-ft | vq-ft
    cross_attn_make_trainable: bool = True
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
    remat: bool = False
    compute_dtype: str = "bfloat16"
    emb_size: int = 768
    num_latent_classes: int = 5
    num_labels_per_class: int = 3
    use_mask_encoder: bool = True
    use_mask_decoder: bool = True
    word_embedding_size: int = 768
    num_latent_gen_factors: int = 8
    mask_pct_train: float = 0.0
    mask_pct_val: float = 0.0
    mask_pct_test: float = 0.0
    vq_mode: str = "VectorQuantizer"
    vq_n_e: int = 9
    vq_e_dim: int = 768
    vq_beta: float = 0.69
    vq_codebook_init_values_path: Optional[str] = None
    enc_out_size: int = 768
    vq_temperature: float = 1.0
    vq_kl_div_scale: float = 5e-4
    vq_straight_through: bool = False
    vq_use_fused: object = "auto"
    fused_ce: bool = True
    fused_head_ce: str = "auto"  # "auto" | "off" | "store" | "flash"; "auto" is off here
    head_ce_block_r: int = 512
    head_ce_block_v: int = 1024
    fused_attn: str = "auto"
    sdpa_block_b: int = 64
    fused_layer: str = "auto"
    layer_block_b_fwd: int = 128
    layer_block_b_bwd: int = 32
    layer_attn_chunk: int = 8
    layer_attn_chunk_fwd: int = 4
    vq_ema_update: bool = False
    vq_ema_decay: float = 0.99
    vq_dead_code_threshold: int = 0
    from_pretrained_bagon: Optional[str] = None
    init_from_ckpt: Optional[str] = None
    hf_encoder_checkpoint: Optional[str] = None
    hf_decoder_checkpoint: Optional[str] = None
    # ---- DataConfig
    data_dir: str = "./data/dSentences"
    sentences_file: str = "dSentences_sentences_clean.npy"
    labels_file: str = "dSentences_latent_classes_labels_clean.npy"
    one_hot_file: str = "dSentences_latent_classes_one_hot_clean.npy"
    input_ids_file: str = "dSentences_input_ids.npy"
    attention_mask_file: str = "dSentences_attention_mask.npy"
    tokenizer_file: str = "dSentences_tokenizer.json"
    train_split_pct: float = 0.6
    val_split_pct: float = 0.2
    batch_size: int = 256
    lim_batches_train_pct: float = 1.0
    lim_batches_val_pct: float = 1.0
    lim_batches_test_pct: float = 1.0
    tokenizer_add_special_tokens: bool = True
    tokenized_sentence_max_length: int = 12
    generate_if_missing: bool = True
    mmap: bool = False
    tokenizer_name: str = ""
    tokenizer_name_encoder: str = ""
    tokenizer_name_decoder: str = ""
    num_workers: int = 0
    pin_memory: bool = False
    # ---- OptimConfig
    lr: float = 1e-4
    weight_decay: float = 0.0
    amsgrad: bool = True
    # "auto" and "on": the AMSGrad kernel (#14) on CUDA; "jnp": its plain
    # single-expression version; "off": the optax-form update, leaf by leaf
    fused_update: str = "auto"
    lr_scheduler: Optional[str] = None
    milestones: tuple = ()
    gamma: float = 0.1
    loss_recon_rescale_factor: float = 1.0
    loss_recon_weight: float = 1.0
    loss_latent_rescale_factor: float = 1.0
    loss_latent_weight: float = 1.0
    loss_vq_rescale_factor: float = 1.0
    loss_vq_weight: float = 1.0
    loss_perp_rescale_factor: float = 1.0
    loss_perp_weight: float = 1.0
    # ---- RunConfig
    n_epochs: int = 10
    n_epochs_to_decode_after: int = 5
    runs_dir: str = "./runs"
    export_checkpoint: bool = True
    test_stage: bool = True
    decode_dump: bool = True
    ckpt_every_n_epochs: int = 1
    ckpt_slots: tuple = ()
    ckpt_async: bool = True
    resume_save_every_n_epochs: int = 0
    seed: int = 0
    rng_impl: str = "rbg"
    encoder_perturb_train_pct: float = 0.0
    encoder_perturb_val_pct: float = 0.0
    encoder_perturb_test_pct: float = 0.0
    decoder_perturb_train_pct: float = 0.0
    decoder_perturb_val_pct: float = 0.0
    decoder_perturb_test_pct: float = 0.0
    bagon_target_unperturbed: bool = False
    wandb_project_name: str = "kindergarten-vq-vae-tpu"
    wandb_group: str = ""
    wandb_job_type: str = "train"
    wandb_mode: str = "disabled"
    wandb_silent: str = "true"
    wandb_watch_model: bool = False
    wandb_watch_histograms: bool = False
    wandb_log_code: bool = False
    profile_dir: str = ""
    mesh_shape: tuple = ()
    mesh_axis_names: tuple = ()

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    def get_config(self) -> dict:
        """The flat dict of ``run_conf.json`` (tuples as lists)."""
        out = dataclasses.asdict(self)
        for k in _TUPLES:
            out[k] = list(out[k])
        return out

    def save(self, path: str, extra: dict | None = None) -> None:
        conf = self.get_config()
        if extra:
            conf.update(extra)
        with open(path, "w") as fp:
            json.dump(conf, fp, default=str)

    @classmethod
    def from_flat_dict(cls, conf: dict) -> "RunConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in conf.items() if k in names}
        for k in _TUPLES:
            if isinstance(kw.get(k), list):
                kw[k] = tuple(kw[k])
        return cls(**kw)

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as fp:
            return cls.from_flat_dict(json.load(fp))


def refuse_unported(cfg: RunConfig) -> None:
    """Raise ``NotImplementedError``, naming the ROADMAP item, for what the
    port does not have yet: a non-empty ``mesh_shape``."""
    if cfg.mesh_shape:
        raise NotImplementedError(f"mesh_shape={tuple(cfg.mesh_shape)} is not ported yet "
                                  "(ROADMAP, modules to port: multi-device)")
