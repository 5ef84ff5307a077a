"""Quality-parity harness of the PyTorch port: the port's Bagon vs an HF
reference built from config.

The twin of ``scripts/parity_harness.py``: the same tiny Bagon architecture
(hidden 128, 2 layers, 2 heads, FFN 256, f32), trained as the port trains it
(``train/step.py``: the fused layers, the CE + argmax, AMSGrad; on the card
through the kernels #1, #2, #7, #8 and #14), and HF's ``BertModel`` +
``BertLMHeadModel`` built from config (the reference's module stack), on
identical pre-tokenized data: the same corpus (``generate_dsentences(
num_verbs=3, num_objects=3)``, cleaned and tokenized by the port's data
modules), the same seed-69 split and the same batch schedule (64 rows a
batch, lr 1e-3). The validation token accuracies are compared: the port's
may be no more than 0.02 below HF's.

    python scripts/parity_harness_torch.py [--epochs 2] [--device cuda|cpu]
        [--json-out path]

The port trains on the card by default; the HF side runs on the CPU and
imports ``transformers`` only when called. The last line of the output is
the result as JSON.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

HIDDEN, LAYERS, HEADS, FFN = 128, 2, 2, 256
BATCH = 64
LR = 1e-3
SEQ = 12
ACC_GAP = 0.02  # the port's val token accuracy may be at most this far below HF's


def _data():
    """``(train, val, vocab_size)``: the harness's corpus, split by seed 69."""
    from kindergarten_vq_vae_torch.data.dataset import DSentences, split_dataset
    from kindergarten_vq_vae_torch.data.generate import generate_dsentences
    from kindergarten_vq_vae_torch.data.prepare import (
        clean_dataset,
        export_vocab,
        labels_to_one_hot,
        tokenize_corpus,
    )
    from kindergarten_vq_vae_torch.data.tokenizer import WordTokenizer

    sentences, labels = generate_dsentences(num_verbs=3, num_objects=3)
    sc, lc, ohc, _ = clean_dataset(sentences, labels, labels_to_one_hot(labels))
    tok = WordTokenizer(export_vocab(sc))
    ids, mask = tokenize_corpus(sc, tok, SEQ)
    ds = DSentences(input_ids=ids, attention_mask=mask, labels=lc, one_hot=ohc, sentences=sc)
    train, val, _ = split_dataset(ds)
    return train, val, tok.vocab_size


def _batches(split, epochs, seed=0):
    """The batch schedule both sides train on."""
    n = len(split)
    for epoch in range(epochs):
        order = np.random.default_rng((seed, epoch)).permutation(n)
        for b in range(n // BATCH):
            idx = order[b * BATCH: (b + 1) * BATCH]
            yield split.input_ids[idx], split.attention_mask[idx]


def train_torch(train, val, vocab_size, epochs) -> float:
    """HF BERT encoder + LM-head decoder on the CPU; val token accuracy."""
    import torch
    import transformers

    torch.manual_seed(0)
    cfg = transformers.BertConfig(
        vocab_size=vocab_size, hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
    )
    dec_cfg = transformers.BertConfig(
        vocab_size=vocab_size, hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=FFN,
        is_decoder=True, add_cross_attention=True,
    )
    encoder = transformers.BertModel(cfg)
    decoder = transformers.BertLMHeadModel(dec_cfg)
    opt = torch.optim.Adam(
        list(encoder.parameters()) + list(decoder.parameters()), lr=LR, amsgrad=True
    )

    encoder.train()
    decoder.train()
    for ids_np, mask_np in _batches(train, epochs):
        ids = torch.as_tensor(ids_np.astype(np.int64))
        mask = torch.as_tensor(mask_np.astype(np.int64))
        h = encoder(ids, attention_mask=mask).last_hidden_state
        logits = decoder(input_ids=ids, attention_mask=mask, encoder_hidden_states=h).logits
        logp = torch.log_softmax(logits.reshape(-1, vocab_size), dim=-1)
        loss = -logp.gather(1, ids.reshape(-1, 1)).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()

    encoder.eval()
    decoder.eval()
    correct = total = 0
    with torch.no_grad():
        for b in range(len(val) // BATCH):
            ids = torch.as_tensor(val.input_ids[b * BATCH: (b + 1) * BATCH].astype(np.int64))
            mask = torch.as_tensor(val.attention_mask[b * BATCH: (b + 1) * BATCH].astype(np.int64))
            h = encoder(ids, attention_mask=mask).last_hidden_state
            logits = decoder(input_ids=ids, attention_mask=mask, encoder_hidden_states=h).logits
            correct += int((logits.argmax(-1) == ids).sum())
            total += ids.numel()
    return correct / total


def train_ours(train, val, vocab_size, epochs, device: str = "cuda") -> float:
    """The port's f32 Bagon trained with its own step (dropout on, AMSGrad),
    then its deterministic eval step's reconstruction ids over every val
    position; val token accuracy."""
    import torch

    from kindergarten_vq_vae_torch.config import RunConfig
    from kindergarten_vq_vae_torch.models import build_model, init_weights
    from kindergarten_vq_vae_torch.train.step import (
        init_train_state,
        make_eval_step,
        make_train_step,
    )

    dev = torch.device(device)
    cfg = RunConfig(model_name="bagon", vocab_size=vocab_size, hidden_size=HIDDEN,
                    num_layers=LAYERS, num_heads=HEADS, intermediate_size=FFN,
                    compute_dtype="float32", batch_size=BATCH,
                    tokenized_sentence_max_length=SEQ, lr=LR)
    model = build_model(cfg, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    state = init_train_state(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(1)
    step = make_train_step(cfg, dev, gen)
    evaluate = make_eval_step(cfg, "val")

    def batch(ids, mask):
        return {"input_ids": torch.as_tensor(ids.astype(np.int64), device=dev),
                "attention_mask": torch.as_tensor(mask.astype(np.int64), device=dev),
                "n_valid": len(ids)}

    for ids_np, mask_np in _batches(train, epochs):
        state, _ = step(state, batch(ids_np, mask_np))

    correct = torch.zeros((), dtype=torch.int64, device=dev)
    total = 0
    for b in range(len(val) // BATCH):
        rows = slice(b * BATCH, (b + 1) * BATCH)
        vb = batch(val.input_ids[rows], val.attention_mask[rows])
        aux = evaluate(model, vb, gen)
        correct += (aux["recon_ids"] == vb["input_ids"]).sum()
        total += vb["input_ids"].numel()
    return int(correct) / total


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", default="cuda", help="the port's device (cuda, or cpu)")
    p.add_argument("--json-out", default=None)
    args = p.parse_args(argv)

    train, val, vocab = _data()
    print(f"corpus: {len(train)} train / {len(val)} val, vocab {vocab}")

    t0 = time.perf_counter()
    acc_ours = train_ours(train, val, vocab, args.epochs, args.device)
    t_ours = time.perf_counter() - t0
    print(f"ours  : val token acc {acc_ours:.4f}  ({t_ours:.1f}s on {args.device})")

    t0 = time.perf_counter()
    acc_torch = train_torch(train, val, vocab, args.epochs)
    t_torch = time.perf_counter() - t0
    print(f"torch : val token acc {acc_torch:.4f}  ({t_torch:.1f}s)")

    result = {
        "epochs": args.epochs,
        "device": args.device,
        "ours_val_token_acc": acc_ours,
        "torch_val_token_acc": acc_torch,
        "acc_gap": acc_ours - acc_torch,
        "ours_seconds": t_ours,
        "torch_seconds": t_torch,
    }
    print(json.dumps(result))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)
    if acc_ours < acc_torch - ACC_GAP:
        raise SystemExit(f"quality parity violated: {acc_ours:.4f} < {acc_torch:.4f} - {ACC_GAP}")
    return result


if __name__ == "__main__":
    main()
