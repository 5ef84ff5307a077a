"""The train / eval engine: epochs, stages, best-slot checkpoints, resume.

Counterpart of ``kindergarten_vq_vae_tpu/train/engine.py``:

- one train step (:func:`~kindergarten_vq_vae_torch.train.step.make_train_step`:
  loss, backward, the update of the trainable leaves, the EMA codebook, the
  dead-code reset) and one eval step per stage;
- ``fit``: per epoch the train stage, its console line and wandb log, the
  val stage, the best-slot checkpoints (gated on the val stats for the val
  slots), the history and the resume bundle at its cadence; ``test``:
  reloads the best-val ``loss_recon`` slot and runs the test split;
- stats are summed on the device as lazy scalars weighted by ``n_valid``
  and read with one host sync per stage; step 0 and the decode dump are
  timed out of ``sentences_per_sec`` (``torch.cuda.synchronize`` where JAX
  blocks on the result);
- randomness is keyed, as JAX keys it by ``fold_in(base, epoch * 1_000_003
  + i * 3 + stage)``: before every step the stage's generator is re-seeded
  from ``(seed + 1, epoch * 1_000_003 + i * 3 + stage)``, and the train
  batches are shuffled by ``(seed, epoch)``, so a resumed run repeats the
  trajectory of an uninterrupted one exactly;
- the parameters are updated in place, so a checkpoint copies them to the
  host before ``fit`` goes on, and only the disk write runs in the
  background (``ckpt_async``).

The decode dump decodes the reconstruction ids with the run's encoder
tokenizer, as JAX's engine does (l.438-441): with the GPT-2 decoder they are
BPE ids, so the dumped reconstructions are not its text (a fault of the
reference, kept for parity).

``profile_dir`` traces the first train epoch with :mod:`torch.profiler`
(a Chrome trace in that directory). ``wandb_watch_model`` logs the global
gradient norm and each leaf's gradient and parameter norms;
``wandb_watch_histograms`` logs 64-bin histograms of each leaf's values and
of its gradient instead, the gradient recomputed on the epoch's last train
batch with that step's draws.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from kindergarten_vq_vae_torch.ckpt.bridge import params_from_jax
from kindergarten_vq_vae_torch.ckpt.checkpoint import (
    AsyncCheckpointWriter,
    best_ckpt_name,
    load_bagon_into_model,
    load_params,
    model_tree,
    read_checkpoint,
    save_checkpoint_multi,
    write_checkpoint,
)
from kindergarten_vq_vae_torch.config import (
    RunConfig,
    refuse_unported,
    refuse_unported_route,
)
from kindergarten_vq_vae_torch.data.dataset import BatchIterator
from kindergarten_vq_vae_torch.models import build_model, init_weights
from kindergarten_vq_vae_torch.ops.vq import EMAState
from kindergarten_vq_vae_torch.train.step import (
    init_train_state,
    make_eval_step,
    make_train_step,
)
from kindergarten_vq_vae_torch.train.variants import (
    BEST_MODES,
    CKPT_KEYS,
    LABEL_KEYS,
    STAT_KEYS,
    _resolve_head_ce,
    load_codebook_init,
    make_loss_fn,
)
from kindergarten_vq_vae_torch.utils import console
from kindergarten_vq_vae_torch.utils.consts import EXPLICIT_FACTOR_VALUES

STAGE_IDS = {"train": 0, "val": 1, "test": 2}
_BATCH_KEYS = ("input_ids", "attention_mask", "dec_input_ids", "dec_attention_mask")


def explicit_latent_classes_labels(labels5) -> dict:
    """Names of the values of the 5 clean factors."""
    out = {}
    for i, (name, values) in enumerate(EXPLICIT_FACTOR_VALUES.items()):
        idx = int(labels5[i])
        out[name] = values[idx] if 0 <= idx < len(values) else str(idx)
    return out


def step_seed(seed: int, epoch: int, i: int, stage: str) -> int:
    """The generator seed of step ``i`` of ``stage`` in ``epoch``."""
    n = epoch * 1_000_003 + i * 3 + STAGE_IDS[stage]
    return int(np.random.SeedSequence([seed + 1, n]).generate_state(1, np.uint64)[0])


class Engine:
    def __init__(self, cfg: RunConfig, splits: dict, tokenizer=None, run_path: str | None = None,
                 params=None, device="cuda"):
        """``params``: initial weights as a Flax tree or a state dict (the
        seeded initialisation of ``cfg.seed`` when None)."""
        refuse_unported(cfg)
        self.cfg, self.splits, self.tokenizer, self.run_path = cfg, splits, tokenizer, run_path
        self.model_name = cfg.model_name
        self.device = torch.device(device)
        refuse_unported_route(cfg, self.device)

        # the training and eval steps share the model: built for the fused
        # head + CE when the run asks for it (a served run takes the logits)
        self._fused_head = _resolve_head_ce(cfg) is not None
        self._batch_keys = _BATCH_KEYS + LABEL_KEYS.get(cfg.model_name, ())
        model = build_model(cfg, device=self.device, fused_head=self._fused_head)
        if params is not None:
            state = params_from_jax(params) if "encoder" in params else params
            model.load_state_dict(state, strict=True)
        else:
            init_weights(model, torch.Generator(device=self.device).manual_seed(cfg.seed))
            init_values = load_codebook_init(cfg)
            if (init_values is not None and cfg.model_name == "shelgon3"
                    and cfg.vq_mode == "VectorQuantizer"):
                with torch.no_grad():
                    model.vector_quantizer.codebook.copy_(torch.as_tensor(init_values))
        if cfg.from_pretrained_bagon:
            load_bagon_into_model(model, cfg.from_pretrained_bagon)
        if cfg.init_from_ckpt:
            load_params(model, cfg.init_from_ckpt)
        self.state = init_train_state(cfg, model)

        self._gen = torch.Generator(device=self.device)
        self._train_step = make_train_step(cfg, self.device, self._gen)
        self._eval_steps = {stage: make_eval_step(cfg, stage) for stage in ("val", "test")}
        self._last_train_batch: tuple[dict, int] | None = None  # for the gradient histograms
        self.decoded_sentences: list[dict] = []
        self.history: list[dict] = []
        self._start_epoch = 1
        self._best_train: dict | None = None
        self._best_val: dict | None = None
        self._ckpt_owed: set[tuple[str, str]] = set()
        self._ckpt_writer: AsyncCheckpointWriter | None = None

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    # ------------------------------------------------------------------ loops

    def _iterators(self) -> dict:
        c = self.cfg
        return {
            "train": BatchIterator(self.splits["train"], c.batch_size, shuffle=True, seed=c.seed,
                                   lim_batches_pct=c.lim_batches_train_pct, drop_last=True),
            "val": BatchIterator(self.splits["val"], c.batch_size,
                                 lim_batches_pct=c.lim_batches_val_pct),
            "test": BatchIterator(self.splits["test"], c.batch_size,
                                  lim_batches_pct=c.lim_batches_test_pct),
        }

    def _init_best(self) -> dict:
        return {k: (np.inf if BEST_MODES[k] == "min" else -np.inf)
                for k in STAT_KEYS[self.model_name] if k in BEST_MODES}

    @staticmethod
    def _update_best(best: dict, stats: dict) -> dict:
        flags = {}
        for k in best:
            flags[k] = stats[k] < best[k] if BEST_MODES[k] == "min" else stats[k] > best[k]
            if flags[k]:
                best[k] = stats[k]
        return flags

    def _put_batch(self, batch: dict) -> dict:
        out = {"n_valid": int(batch["n_valid"])}
        for k in self._batch_keys:
            if k in batch:
                t = torch.from_numpy(np.asarray(batch[k], dtype=np.int64))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[k] = t
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_stage(self, stage: str, iterator, epoch: int, decode: bool, model=None) -> dict:
        stat_keys = STAT_KEYS[self.model_name]
        run = {k: torch.zeros((), device=self.device) for k in stat_keys}
        n_els = n_steps = els_first = 0
        t_first = t_decode = 0.0
        t0 = time.perf_counter()
        for i, batch in enumerate(iterator):
            n_valid = int(batch["n_valid"])
            dbatch = self._put_batch(batch)
            seed = step_seed(self.cfg.seed, epoch, i, stage)
            self._gen.manual_seed(seed)
            if stage == "train":
                self.state, aux = self._train_step(self.state, dbatch)
                if self.cfg.wandb_watch_histograms:
                    self._last_train_batch = (dbatch, seed)
            else:
                aux = self._eval_steps[stage](model or self.model, dbatch, self._gen)
            if i == 0:
                self._sync()  # step 0 (and its first-use costs) is timed on its own
                t_first = time.perf_counter() - t0
                els_first = n_valid
            for k in stat_keys:
                is_acc = k.startswith("metric_") and "acc" in k
                scale = 1.0 if k == "padding_tokens_pct" else (
                    100.0 * n_valid if is_acc else float(n_valid))
                run[k] = run[k] + aux[k] * scale
            n_els += n_valid
            n_steps += 1
            if decode:
                self._sync()  # the device's queue counts as step time, not decode time
                td = time.perf_counter()
                self._decode_batch(batch, aux, epoch, stage)
                t_decode += time.perf_counter() - td
            if "grad_norm" in aux:
                run["grad_norm"] = run.get("grad_norm", 0.0) + aux["grad_norm"]
                run["watch_grads"] = run.get("watch_grads", 0.0) + aux["watch_grads"]
        # one host sync for the whole stage
        values = torch.stack([run[k] for k in stat_keys]).tolist()
        stats = {}
        for k, v in zip(stat_keys, values):
            stats[k] = v / (n_steps if k == "padding_tokens_pct" else max(n_els, 1))
        if "grad_norm" in run:
            stats["grad_norm"] = float(run["grad_norm"]) / max(n_steps, 1)
            stats["watch_grads"] = run["watch_grads"].cpu().numpy() / max(n_steps, 1)
        elapsed = time.perf_counter() - t0
        steady_els, steady_t = n_els - els_first, elapsed - t_first - t_decode
        if steady_els > 0 and steady_t > 1e-9:
            stats["sentences_per_sec"] = steady_els / steady_t
        else:
            stats["sentences_per_sec"] = n_els / max(elapsed - t_decode, 1e-9)
        stats["stage_wall_s"] = elapsed
        stats["n_els"] = n_els
        return stats

    def _decode_batch(self, batch, aux, epoch: int, stage: str) -> None:
        if self.tokenizer is None:
            return
        input_dec = self.tokenizer.batch_decode(np.asarray(batch["input_ids"]))
        recon_dec = self.tokenizer.batch_decode(aux["recon_ids"].cpu().numpy())
        accs = aux["acc_per_sentence"].cpu().numpy()
        labels = batch.get("labels")
        for j in range(int(batch["n_valid"])):
            row = {"epoch": epoch, "stage": stage, "input_sentence": input_dec[j],
                   "recon_sentence": recon_dec[j], "sentence_acc": float(accs[j])}
            if labels is not None and labels.shape[1] == 5:
                row.update(explicit_latent_classes_labels(labels[j]))
            self.decoded_sentences.append(row)

    def _train_stage(self, iterator, epoch: int, decode: bool) -> dict:
        if not (self.cfg.profile_dir and epoch == 1):
            return self._run_stage("train", iterator, epoch, decode)
        from kindergarten_vq_vae_torch.utils.profiling import trace

        with trace(self.cfg.profile_dir, self.device, "train_epoch_1.json"):
            return self._run_stage("train", iterator, epoch, decode)

    # ------------------------------------------------------------------ state

    def _state_tree(self) -> dict:
        st = self.state
        opt = st.opt_state
        names = [n for n, _ in st.trainable()]
        tree = {"params": model_tree(self.model), "step": np.int64(st.step),
                "opt_state": {"count": np.int64(opt.count), "mu": dict(zip(names, opt.mu)),
                              "nu": dict(zip(names, opt.nu))}}
        if opt.nu_max is not None:
            tree["opt_state"]["nu_max"] = dict(zip(names, opt.nu_max))
        if st.ema is not None:
            tree["ema_counts"], tree["ema_means"] = st.ema.counts, st.ema.means
        if st.dead_steps is not None:
            tree["dead_steps"] = st.dead_steps
        return tree

    def save_state(self, path: str, use_writer: bool = False, after=None) -> None:
        """The resume bundle: params, optimizer state, step (EMA and dead-code
        state where present). ``use_writer`` sends the disk write through the
        async writer; ``after`` runs once the bundle is durable."""
        writer = self._writer() if use_writer else None
        if writer is not None:
            writer.save(path, self._state_tree(), after=after)
            return
        write_checkpoint(path, self._state_tree())
        if after is not None:
            after()

    @torch.no_grad()
    def restore_state(self, path: str) -> None:
        tree = read_checkpoint(path)
        st, dev = self.state, self.device

        def put(dst: torch.Tensor, src) -> None:
            src = torch.as_tensor(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"resume bundle {path}: shape {tuple(src.shape)} for a "
                                 f"{tuple(dst.shape)} tensor")
            dst.copy_(src.to(dtype=dst.dtype))

        loaded = params_from_jax(tree["params"])
        for name, p in self.model.named_parameters():
            put(p, loaded[name])
        opt, names = st.opt_state, [n for n, _ in st.trainable()]
        for key, leaves in (("mu", opt.mu), ("nu", opt.nu), ("nu_max", opt.nu_max)):
            for name, t in zip(names, leaves or ()):
                put(t, tree["opt_state"][key][name])
        opt.count = int(tree["opt_state"]["count"])
        st.step = int(tree["step"])
        if st.ema is not None:
            st.ema = EMAState(torch.as_tensor(tree["ema_counts"]).to(dev),
                              torch.as_tensor(tree["ema_means"]).to(dev))
        if st.dead_steps is not None:
            st.dead_steps = torch.as_tensor(tree["dead_steps"]).to(dev)

    def save_resume(self, epoch: int, best_train: dict, best_val: dict) -> None:
        """Overwrite ``<run_dir>/resume_state`` and ``resume_meta.json`` (the
        epoch reached, the best trackers, the history); the meta is written
        only once the bundle it describes is durable."""
        if not self.run_path:
            return
        meta_json = json.dumps({
            "epoch": epoch,
            "best_train": {k: float(v) for k, v in best_train.items()},
            "best_val": {k: float(v) for k, v in best_val.items()},
            "history": list(self.history),
        }, default=float)
        meta_path = os.path.join(self.run_path, "resume_meta.json")

        def write_meta():
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(meta_json)
            os.replace(tmp, meta_path)

        self.save_state(os.path.join(self.run_path, "resume_state"), use_writer=True,
                        after=write_meta)

    def restore_resume(self, run_dir: str | None = None) -> int:
        """Restore a run saved by :meth:`save_resume`; returns the next epoch."""
        run_dir = run_dir or self.run_path
        self.restore_state(os.path.join(run_dir, "resume_state"))
        with open(os.path.join(run_dir, "resume_meta.json")) as f:
            meta = json.load(f)
        self._best_train, self._best_val = meta["best_train"], meta["best_val"]
        self.history = meta["history"]
        self._start_epoch = int(meta["epoch"]) + 1
        return self._start_epoch

    # ------------------------------------------------------------------ public

    def fit(self, wandb_run=None, console_print: bool = True) -> list[dict]:
        cfg = self.cfg
        iters = self._iterators()
        best_train = self._best_train or self._init_best()
        best_val = self._best_val or self._init_best()
        progress = None
        if console_print:
            progress = console.ProgressLine(f"epochs ({self.model_name})",
                                            cfg.n_epochs - self._start_epoch + 1)
        for epoch in range(self._start_epoch, cfg.n_epochs + 1):
            iters["train"].set_epoch(epoch)
            decode = cfg.decode_dump and (epoch % cfg.n_epochs_to_decode_after) == 0
            stats_train = self._train_stage(iters["train"], epoch, decode)
            flags_train = self._update_best(best_train, stats_train)
            if progress is not None:
                progress.clear()
            self._log_epoch(epoch, "train", stats_train, flags_train, wandb_run, console_print)
            stats_val = self._run_stage("val", iters["val"], epoch, decode)
            flags_val = self._update_best(best_val, stats_val)
            self._log_epoch(epoch, "val", stats_val, flags_val, wandb_run, console_print)
            self._checkpoint_epoch(epoch, flags_train, flags_val)
            self.history.append({"epoch": epoch, "train": _plain(stats_train),
                                 "val": _plain(stats_val)})
            cadence = cfg.resume_save_every_n_epochs
            if cadence > 0 and epoch % cadence == 0:
                self.save_resume(epoch, best_train, best_val)
            if progress is not None:
                progress.advance()
        if progress is not None:
            progress.clear()
        self.drain_checkpoints()
        return self.history

    def test(self, wandb_run=None, console_print: bool = True, reload_best: bool = True) -> dict:
        """Run the test split on the best-val ``loss_recon`` slot (the current
        parameters when there is none)."""
        model = None
        if reload_best and self.run_path and self.cfg.export_checkpoint:
            path = os.path.join(self.run_path,
                                best_ckpt_name(self.model_name, "loss_recon", "val"))
            if os.path.exists(path):
                model = build_model(self.cfg, device=self.device, fused_head=self._fused_head)
                load_params(model, path)
        stats = self._run_stage("test", self._iterators()["test"], self.cfg.n_epochs,
                                self.cfg.decode_dump, model)
        flags = {k: False for k in self._init_best()}
        self._log_epoch(self.cfg.n_epochs, "test", stats, flags, wandb_run, console_print)
        self.history.append({"epoch": self.cfg.n_epochs, "test": _plain(stats)})
        return stats

    def dump_decoded_sentences(self) -> str | None:
        """``decoded_sentences.feather`` when pandas and pyarrow are present,
        else ``decoded_sentences.jsonl``."""
        if not self.run_path:
            return None
        try:
            import pandas as pd

            path = os.path.join(self.run_path, "decoded_sentences.feather")
            pd.DataFrame(self.decoded_sentences).to_feather(path)
            return path
        except (ImportError, ValueError):
            path = os.path.join(self.run_path, "decoded_sentences.jsonl")
            with open(path, "w") as f:
                for row in self.decoded_sentences:
                    f.write(json.dumps(row) + "\n")
            return path

    # ------------------------------------------------------------------ intern

    def _checkpoint_epoch(self, epoch: int, flags_train: dict, flags_val: dict) -> None:
        """Best slots of every stat that improved, written as one bundle plus
        hardlinks; ``ckpt_every_n_epochs`` > 1 owes them to its cadence epoch
        and the last, 0 to the last epoch only."""
        if not (self.run_path and self.cfg.export_checkpoint):
            return
        allowed = {tuple(s.split(":", 1)) for s in self.cfg.ckpt_slots} or None
        for stat in CKPT_KEYS[self.model_name]:
            for stage, flags in (("train", flags_train), ("val", flags_val)):
                if flags.get(stat) and (allowed is None or (stat, stage) in allowed):
                    self._ckpt_owed.add((stat, stage))
        if not self._ckpt_owed:
            return
        cadence = int(self.cfg.ckpt_every_n_epochs)
        last = epoch == self.cfg.n_epochs
        if (cadence <= 0 and not last) or (cadence > 0 and epoch % cadence and not last):
            return
        paths = [os.path.join(self.run_path, best_ckpt_name(self.model_name, stat, stage))
                 for stat, stage in sorted(self._ckpt_owed)]
        writer = self._writer()
        if writer is not None:
            writer.save_multi(paths, model_tree(self.model))
        else:
            save_checkpoint_multi(paths, model_tree(self.model))
        self._ckpt_owed.clear()

    def _writer(self) -> AsyncCheckpointWriter | None:
        if not self.cfg.ckpt_async:
            return None
        if self._ckpt_writer is None:
            self._ckpt_writer = AsyncCheckpointWriter()
        return self._ckpt_writer

    def drain_checkpoints(self) -> None:
        """Block until every queued checkpoint write is durable."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()

    def _log_epoch(self, epoch, stage, stats, flags, wandb_run, console_print) -> None:
        keys = STAT_KEYS[self.model_name]
        if console_print:
            strs, best = [], []
            for k in keys:
                if k.startswith("loss"):
                    strs.append(f"{k}: {stats[k]:09.6f}")
                    best.append(bool(flags.get(k)))
            strs.append(f"acc: {stats['metric_acc']:08.4f}%")
            best.append(bool(flags.get("metric_acc")))
            if "metric_perp" in stats:
                strs.append(f"perp: {stats['metric_perp']:06.3f}")
                best.append(False)
            strs.append(f"{stats['sentences_per_sec']:.1f} sent/s")
            best.append(False)
            if console.color_enabled():
                print(console.epoch_line(epoch, stage, strs, best))
            else:
                print(" | ".join([f"{epoch:03d} | {stage:<5}"]
                                 + [s + (" *" if b else "") for s, b in zip(strs, best)]))
        if wandb_run is None:
            return
        log = {"epoch": epoch}
        if "grad_norm" in stats:
            log[f"{stage}/grad_norm"] = stats["grad_norm"]
        if "watch_grads" in stats and not self.cfg.wandb_watch_histograms:
            names = [n for n, _ in self.model.named_parameters()]
            for n, v in zip(names, stats["watch_grads"]):
                log[f"gradients/{n}"] = float(v)
            with torch.no_grad():
                pnorms = torch.stack([torch.sqrt(torch.sum(torch.square(p.float())))
                                      for p in self.model.parameters()]).tolist()
            for n, v in zip(names, pnorms):
                log[f"parameters/{n}"] = v
        if (self.cfg.wandb_watch_histograms and stage == "train"
                and self._last_train_batch is not None):
            self._log_watch_histograms(log)
        for k in keys:
            if k == "padding_tokens_pct":
                log[f"padding_tokens_pct/{stage}"] = stats[k]
            elif k.startswith("loss"):
                log[f"{stage}/{k}"] = stats[k]
            else:
                log[f"{stage}/{k.replace('metric_', '')}"] = stats[k]
        wandb_run.log(log)


    def _log_watch_histograms(self, log: dict) -> None:
        """64-bin histograms of every leaf's values and of its gradient on the
        epoch's last train batch (recomputed with that step's draws from the
        current parameters), under ``parameters/<name>`` and
        ``gradients/<name>``; a leaf the loss does not reach has a zero
        gradient, as in JAX."""
        batch, seed = self._last_train_batch
        named = list(self.model.named_parameters())
        for _, p in named:
            p.grad = None
        self._gen.manual_seed(seed)
        loss, _ = make_loss_fn(self.cfg, "train")(self.model, batch, self._gen, False)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for _, p in named]
        pc, pr = stacked_hists([p for _, p in named])
        gc, gr = stacked_hists(grads)
        for i, (name, _) in enumerate(named):
            log[f"parameters/{name}"] = _hist_payload(pc[i], pr[i, 0], pr[i, 1])
            log[f"gradients/{name}"] = _hist_payload(gc[i], gr[i, 0], gr[i, 1])


@torch.no_grad()
def stacked_hists(tensors, bins: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """``(counts (L, bins), ranges (L, 2))``: a histogram of each tensor over
    its own ``[min, max]`` (a constant tensor gets a range of width 1), the
    arithmetic of the JAX engine's ``_stacked_hists``; one host copy for all."""
    counts, ranges = [], []
    for t in tensors:
        x = t.float().reshape(-1)
        lo, hi = x.min(), x.max()
        hi_ = torch.where(hi > lo, hi, lo + 1.0)
        idx = ((x - lo) / (hi_ - lo) * bins).to(torch.int32).clamp(0, bins - 1)
        counts.append(torch.bincount(idx.long(), minlength=bins))
        ranges.append(torch.stack([lo, hi_]))
    return torch.stack(counts).cpu().numpy(), torch.stack(ranges).cpu().numpy()


def _hist_payload(counts, lo, hi):
    """A ``wandb.Histogram`` when wandb is installed, else a plain dict with
    the same content."""
    edges = np.linspace(float(lo), float(hi), len(counts) + 1)
    try:
        import wandb
    except ImportError:
        return {"_type": "histogram", "values": counts.tolist(), "bins": edges.tolist()}
    return wandb.Histogram(np_histogram=(counts.tolist(), edges.tolist()))


def _plain(stats: dict) -> dict:
    """Stats as JSON values (the per-leaf gradient norms as a list)."""
    return {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in stats.items()}
