"""Batched inference serving for a trained run, in PyTorch.

Counterpart of ``kindergarten_vq_vae_tpu/serve/reconstructor.py``: a
checkpoint-backed reconstructor with size buckets. A request is cut into
chunks of at most the largest bucket, each chunk is padded up to the
smallest bucket that holds it by repeating its first row, and the padding is
dropped from the results.

- ``reconstruct``: sentences -> reconstructed sentences (+ token accuracy,
  + codes for shelgon3)
- ``encode``: sentences -> sentence-level latents (encoder pooler output)
- ``codes``: sentences -> codebook indices (shelgon3, either quantizer)

Each variant takes its own forward (JAX l.59-71): Bagon and Shelgon the
same ids and mask on both sides, Shelgon3 with ``is_training`` off (the
Gumbel quantizer hard), Shelgon2 its two arguments. The Gumbel noise of
Shelgon, Shelgon2 and Shelgon3-Gumbel comes from a generator seeded 0 on
each forward, the counterpart of JAX's ``key(0)``. On CUDA every layer and
the VQ bottleneck run as the package's kernels, in bf16 or f32, on either
trunk (an f32 run needs full-f32 matrix products:
``config.refuse_unported_route``).

A run with the GPT-2 decoder is served as JAX serves it: the encoder's ids
feed the decoder too, and the argmax is decoded with the run's encoder
tokenizer (a fault of the reference, kept for parity: the decoder's ids are
BPE ids). Where an encoder id is at or above the decoder's vocabulary, JAX's
embedding gather fills NaN rows; here ``reconstruct`` and ``codes`` raise
``ValueError`` naming both vocabularies.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.ckpt.checkpoint import best_ckpt_name, read_checkpoint
from kindergarten_vq_vae_torch.config import RunConfig, refuse_unported_route
from kindergarten_vq_vae_torch.data.tokenizer import _BaseTokenizer
from kindergarten_vq_vae_torch.models import build_model


def model_inputs(model_name: str, ids: torch.Tensor, mask: torch.Tensor) -> tuple[tuple, dict]:
    """The served forward's model arguments (JAX l.59-71): Bagon and Shelgon
    the same ids and mask on both sides, Shelgon3 with ``is_training`` off."""
    if model_name in ("bagon", "shelgon"):
        return (ids, mask, ids, mask), {}
    if model_name == "shelgon3":
        return (ids, mask), {"is_training": False}
    return (ids, mask), {}


def served_outputs(out: dict, ids: torch.Tensor):
    """(reconstruction ids, codes or zeros), both (B, S), from the model's output."""
    recon_ids = torch.argmax(out["logits"], dim=-1)
    codes = out.get("min_encoding_indices")
    return recon_ids, (codes[..., 0] if codes is not None else torch.zeros_like(ids))


class Reconstructor:
    """``artifact``: serve an exported program (``serve/export.py``, JAX
    l.26-50) at its one bucket instead of the live forward; the run's
    parameters go in as its argument, and a run of another model or
    ``seq_len`` than the artifact's raises ``ValueError``."""

    def __init__(self, run_path: str, ckpt_name: str | None = None,
                 batch_buckets: tuple = (8, 64, 256), device="cuda",
                 artifact: str | None = None):
        self.cfg = RunConfig.load(os.path.join(run_path, "run_conf.json"))
        self.device = torch.device(device)
        refuse_unported_route(self.cfg, self.device)
        self.model_name = self.cfg.model_name
        self.model = build_model(self.cfg, device=self.device).eval()
        if ckpt_name is None:
            ckpt_name = best_ckpt_name(self.model_name, "loss_recon", "val")
        state = params_from_jax(read_checkpoint(os.path.join(run_path, ckpt_name)))
        self.model.load_state_dict(state, strict=True)
        tok_path = os.path.join(self.cfg.data_dir, self.cfg.tokenizer_file)
        self.tokenizer = _BaseTokenizer.load(tok_path) if os.path.exists(tok_path) else None
        self.seq_len = self.cfg.tokenized_sentence_max_length
        self.buckets = tuple(sorted(batch_buckets))
        self.decoder_vocab_size = self.cfg.decoder_vocab_size or self.cfg.vocab_size
        self.exported = None  # the artifact's call, when the reconstructor serves one
        if artifact is not None:
            from kindergarten_vq_vae_torch.serve.export import load_exported

            call, meta = load_exported(artifact, device=self.device)
            if meta["model_name"] != self.model_name or meta["seq_len"] != self.seq_len:
                raise ValueError(
                    f"artifact {artifact} was exported for {meta['model_name']}/seq"
                    f"{meta['seq_len']}, run is {self.model_name}/seq{self.seq_len}")
            self.buckets = (int(meta["bucket"]),)
            self.exported = call
            self._params = {k: v.detach() for k, v in self.model.state_dict().items()}

    # ------------------------------------------------------------------ core

    def forward(self, ids: torch.Tensor, mask: torch.Tensor, reference: bool = False):
        """(reconstruction ids, codes or zeros), both (B, S), on the device:
        the live forward, or the artifact's when the reconstructor serves one
        (``reference`` takes the live forward's plain versions)."""
        if self.exported is not None and not reference:
            return self.exported(self._params, ids, mask)
        args, kwargs = model_inputs(self.model_name, ids, mask)
        gen = torch.Generator(device=self.device).manual_seed(0)
        out = self.model(*args, reference=reference, generator=gen, **kwargs)
        return served_outputs(out, ids)

    def _bucket(self, n: int) -> int:
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    def _padded_chunks(self, ids: np.ndarray, mask: np.ndarray, bucket_of):
        """Yield (chunk length, ids, mask) device tensors padded to a bucket."""
        n, i = len(ids), 0
        while i < n:
            chunk = min(n - i, self.buckets[-1])
            pad = bucket_of(chunk) - chunk
            ids_b = np.concatenate([ids[i:i + chunk], np.repeat(ids[i:i + 1], pad, axis=0)])
            mask_b = np.concatenate([mask[i:i + chunk], np.repeat(mask[i:i + 1], pad, axis=0)])
            yield chunk, torch.from_numpy(ids_b).to(self.device), torch.from_numpy(mask_b).to(self.device)
            i += chunk

    @torch.inference_mode()
    def _run_padded(self, ids: np.ndarray, mask: np.ndarray):
        """Every model forward feeds the encoder's ids to the decoder too, so
        an id outside the decoder's vocabulary raises."""
        top = int(ids.max()) if ids.size else 0
        if top >= self.decoder_vocab_size:
            raise ValueError(
                f"encoder id {top} is outside the decoder's vocabulary "
                f"(decoder_vocab_size={self.decoder_vocab_size}, vocab_size="
                f"{self.cfg.vocab_size}): the served forward feeds the encoder's ids to the "
                "decoder")
        outs_r, outs_c = [], []
        for chunk, ids_t, mask_t in self._padded_chunks(ids, mask, self._bucket):
            r, c = self.forward(ids_t, mask_t)
            outs_r.append(r[:chunk].cpu().numpy())
            outs_c.append(c[:chunk].cpu().numpy())
        return np.concatenate(outs_r), np.concatenate(outs_c)

    def _tokenize(self, sentences: list[str]):
        if self.tokenizer is None:
            raise ValueError("serving needs the run's tokenizer")
        return self.tokenizer.encode_batch(
            sentences, self.seq_len, self.cfg.tokenizer_add_special_tokens)

    # ---------------------------------------------------------------- public

    def reconstruct(self, sentences: list[str]) -> list[dict]:
        ids, mask = self._tokenize(sentences)
        recon_ids, codes = self._run_padded(ids, mask)
        out = []
        for i, s in enumerate(sentences):
            row = {"input": s, "reconstruction": self.tokenizer.decode(recon_ids[i]),
                   "token_acc": float(np.mean(recon_ids[i] == ids[i]))}
            if self.model_name == "shelgon3":
                row["codes"] = codes[i][: int(mask[i].sum())].tolist()
            out.append(row)
        return out

    @torch.inference_mode()
    def encode(self, sentences: list[str]) -> np.ndarray:
        """Sentence-level latents (encoder pooler output), f32 (n, H); every
        chunk is padded to the largest bucket, as the JAX package does."""
        ids, mask = self._tokenize(sentences)
        chunks = []
        for chunk, ids_t, mask_t in self._padded_chunks(ids, mask, lambda _: self.buckets[-1]):
            pooled = self.model.encoder(ids_t, mask_t)["pooler_output"]
            chunks.append(pooled[:chunk].float().cpu().numpy())
        return np.concatenate(chunks)

    def codes(self, sentences: list[str]) -> list[list[int]]:
        """Codebook indices per token (shelgon3)."""
        if self.model_name != "shelgon3":
            raise ValueError("codes() requires a shelgon3 run")
        ids, mask = self._tokenize(sentences)
        _, codes = self._run_padded(ids, mask)
        return [codes[i][: int(mask[i].sum())].tolist() for i in range(len(sentences))]
