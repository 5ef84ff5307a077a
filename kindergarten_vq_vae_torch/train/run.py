"""Run orchestration: data, run directory, training, test, history.

Counterpart of ``kindergarten_vq_vae_tpu/train/run.py``: load (or generate
and prepare) the corpus, split it, make the run directory and its
``run_conf.json``, train (``Engine.fit``), reload the best-val slot and run
the test split (``Engine.test``), dump the decoded sentences and write
``history.json``. The run directory is what
:class:`~kindergarten_vq_vae_torch.serve.reconstructor.Reconstructor` serves.

Under a device mesh (``mesh_shape``; one process a rank, e.g. ``torchrun
--nproc-per-node N -m kindergarten_vq_vae_torch.cli shelgon3 --set
mesh_shape=(N,) --set mesh_axis_names=('dp',)``) every rank runs this:
rank 0 prepares a missing corpus and makes the run directory before the
others read them, and alone writes ``run_conf.json``, ``history.json`` and
the wandb run.
"""

from __future__ import annotations

import json
import os
from datetime import datetime

import numpy as np
import torch.distributed as dist

from kindergarten_vq_vae_torch.config import RunConfig
from kindergarten_vq_vae_torch.data.dataset import DSentences, split_dataset
from kindergarten_vq_vae_torch.data.tokenizer import BPETokenizer, _BaseTokenizer
from kindergarten_vq_vae_torch.parallel.mesh import init_distributed
from kindergarten_vq_vae_torch.train.engine import Engine
from kindergarten_vq_vae_torch.utils.consts import RUN_ID_TIMESTAMP_FORMAT
from kindergarten_vq_vae_torch.utils.params import params_summary_dict


def load_data(cfg: RunConfig):
    """``(splits, tokenizer)`` from the artifacts in ``cfg.data_dir``,
    generated and prepared first when they are missing and
    ``generate_if_missing``. A GPT-2 decoder's run also gets the
    ``dec_input_ids`` / ``dec_attention_mask`` columns of its BPE
    tokenization (:func:`_bpe_tokenize`)."""
    d = cfg.data_dir

    def path(name):
        return os.path.join(d, name)

    if not os.path.exists(path(cfg.input_ids_file)):
        if not cfg.generate_if_missing:
            raise FileNotFoundError(f"{path(cfg.input_ids_file)} missing; set "
                                    "generate_if_missing to generate the corpus")
        from kindergarten_vq_vae_torch.data.generate import generate_dsentences
        from kindergarten_vq_vae_torch.data.prepare import prepare_all

        if not os.path.exists(path("dSentences_sentences.npy")):
            generate_dsentences(d)
        prepare_all(d, max_length=cfg.tokenized_sentence_max_length,
                    add_special_tokens=cfg.tokenizer_add_special_tokens)

    # memory-mapped reads (``mmap``): the columns stay on disk, the splits
    # keep index indirection and a batch reads only its rows
    mmap = "r" if cfg.mmap else None
    input_ids = np.load(path(cfg.input_ids_file), mmap_mode=mmap)
    attention_mask = np.load(path(cfg.attention_mask_file), mmap_mode=mmap)
    labels = np.load(path(cfg.labels_file), mmap_mode=mmap)
    one_hot = np.load(path(cfg.one_hot_file), mmap_mode=mmap)
    sentences = [s.decode() if isinstance(s, bytes) else str(s)
                 for s in np.load(path(cfg.sentences_file))]
    labels8 = one_hot8 = None
    if os.path.exists(path("dSentences_latent_classes_labels8_clean.npy")):
        labels8 = np.load(path("dSentences_latent_classes_labels8_clean.npy"))
        one_hot8 = np.load(path("dSentences_latent_classes_one_hot8_clean.npy"))

    # truncate or pad to the configured length (prepared arrays may differ)
    L = cfg.tokenized_sentence_max_length
    if input_ids.shape[1] > L:
        input_ids, attention_mask = input_ids[:, :L], attention_mask[:, :L]
    elif input_ids.shape[1] < L:
        pad = ((0, 0), (0, L - input_ids.shape[1]))
        input_ids, attention_mask = np.pad(input_ids, pad), np.pad(attention_mask, pad)

    dec_input_ids = dec_attention_mask = None
    if "gpt" in cfg.decoder_model_name:
        dec_input_ids, dec_attention_mask = _bpe_tokenize(cfg, sentences, L)
    ds = DSentences(input_ids=_int32(input_ids), attention_mask=_int32(attention_mask),
                    dec_input_ids=dec_input_ids,
                    dec_attention_mask=dec_attention_mask, labels=labels, one_hot=one_hot,
                    labels8=labels8, one_hot8=one_hot8, sentences=sentences)
    train, val, test = split_dataset(ds, cfg.train_split_pct, cfg.val_split_pct)
    tok_path = path(cfg.tokenizer_file)
    tokenizer = _BaseTokenizer.load(tok_path) if os.path.exists(tok_path) else None
    max_id = int(input_ids.max())
    if max_id >= cfg.vocab_size:
        raise ValueError(
            f"vocab_size={cfg.vocab_size} but the corpus contains token id {max_id}; set "
            f"vocab_size >= {max_id + 1} (tokenizer vocab: "
            f"{tokenizer.vocab_size if tokenizer else 'unknown'})")
    return {"train": train, "val": val, "test": test}, tokenizer


def _int32(col: np.ndarray) -> np.ndarray:
    """``col`` as int32: a memory-mapped int32 column (what ``prepare``
    writes) stays mapped; any other is converted, as JAX converts it."""
    return col if col.dtype == np.int32 else col.astype(np.int32)


def _bpe_tokenize(cfg: RunConfig, sentences: list[str], max_length: int):
    """The GPT-2 decoder's second tokenization of the corpus (JAX l.74-98):
    ``gpt2_vocab.json`` / ``gpt2_merges.txt`` from ``data_dir``, or BPE
    trained from the corpus to ``decoder_vocab_size`` (512 when unset) and
    saved there; a trained vocabulary larger than ``decoder_vocab_size``
    raises."""
    vpath = os.path.join(cfg.data_dir, "gpt2_vocab.json")
    mpath = os.path.join(cfg.data_dir, "gpt2_merges.txt")
    if os.path.exists(vpath) and os.path.exists(mpath):
        tok = BPETokenizer.from_files(vpath, mpath)
    else:
        tok = BPETokenizer.train(sentences, vocab_size=cfg.decoder_vocab_size or 512)
        tok.save(vpath, mpath)
    if cfg.decoder_vocab_size and tok.vocab_size > cfg.decoder_vocab_size:
        raise ValueError(f"decoder_vocab_size={cfg.decoder_vocab_size} < trained BPE vocab "
                         f"{tok.vocab_size}")
    return tok.encode_batch(sentences, max_length=max_length)


def make_run_dir(cfg: RunConfig) -> str:
    run_path = os.path.join(cfg.runs_dir, datetime.now().strftime(RUN_ID_TIMESTAMP_FORMAT))
    os.makedirs(run_path, exist_ok=True)
    return run_path


def init_wandb(cfg: RunConfig, run_conf: dict):
    """A wandb run, or None when ``wandb_mode`` is "disabled" or wandb is
    not installed."""
    if cfg.wandb_mode == "disabled":
        return None
    try:
        import wandb
    except ImportError:
        print("[run] wandb disabled (not installed)")
        return None
    os.environ["WANDB_SILENT"] = cfg.wandb_silent
    return wandb.init(project=cfg.wandb_project_name, group=cfg.wandb_group or None,
                      job_type=cfg.wandb_job_type, config=run_conf, mode=cfg.wandb_mode)


def _rank_zero_first(fn, main: bool, meshed: bool):
    """``fn()`` on rank 0, then on the other ranks once rank 0 is done."""
    if main:
        out = fn()
    if meshed:
        dist.barrier()
    return out if main else fn()


def run_training(cfg: RunConfig, console_print: bool = True, resume_from: str | None = None,
                 device="cuda") -> Engine:
    """The whole run; returns the Engine. ``resume_from``: a run directory
    holding ``resume_state`` and ``resume_meta.json`` (written when
    ``resume_save_every_n_epochs`` > 0); training continues in it from the
    saved epoch, on the same trajectory. Under a mesh the process group is
    joined here unless the caller has joined one (NCCL on CUDA, gloo on the
    CPU)."""
    meshed = bool(cfg.mesh_shape)
    main = True
    if meshed:
        rank, _ = init_distributed(device=device)
        main = rank == 0
    splits, tokenizer = _rank_zero_first(lambda: load_data(cfg), main, meshed)
    run_path = resume_from
    if run_path is None:
        made = [make_run_dir(cfg) if main else None]
        if meshed:
            dist.broadcast_object_list(made, src=0)
        run_path = made[0]
    engine = Engine(cfg, splits, tokenizer=tokenizer, run_path=run_path, device=device)
    console_print = console_print and main
    if resume_from:
        start = engine.restore_resume(resume_from)
        if console_print:
            print(f"[run] resumed {resume_from} at epoch {start}")

    run_conf = cfg.get_config()
    run_conf["run_id"] = os.path.basename(os.path.normpath(run_path))
    run_conf["n_params"] = params_summary_dict(engine.model)
    if not resume_from and main:
        cfg.save(os.path.join(run_path, "run_conf.json"),
                 extra={"run_id": run_conf["run_id"], "n_params": run_conf["n_params"]})

    wandb_run = init_wandb(cfg, run_conf) if main else None
    if wandb_run is not None and cfg.wandb_log_code:
        wandb_run.log_code(".")
    engine.fit(wandb_run=wandb_run, console_print=console_print)
    if cfg.test_stage:
        engine.test(wandb_run=wandb_run, console_print=console_print)
    if cfg.decode_dump:
        engine.dump_decoded_sentences()
    if main:
        with open(os.path.join(run_path, "history.json"), "w") as f:
            json.dump(engine.history, f, default=float)
    if wandb_run is not None:
        wandb_run.finish()
    return engine
