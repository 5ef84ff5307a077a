"""Checkpoint validity smoke check, on the PyTorch port.

The twin of ``scripts/check_checkpoint.py``: rebuild a run's model from its
``run_conf.json`` and checkpoint (``analyses.common.load_run``), run a
three-sentence forward and print the reconstructions. Runs on the card
unless ``--cpu`` is given.

    python scripts/check_checkpoint_torch.py <run_dir> [ckpt_name] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SENTENCES = ["i eat the apple", "he is not buying the mango", "will you be building the chair"]


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("ckpt_name", nargs="?", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from kindergarten_vq_vae_torch.analyses.common import load_run
    from kindergarten_vq_vae_torch.data.tokenizer import _BaseTokenizer

    device = "cpu" if args.cpu else "cuda"
    cfg, model = load_run(args.run_dir, args.ckpt_name, device=device)
    tok_path = os.path.join(cfg.data_dir, cfg.tokenizer_file)
    tokenizer = _BaseTokenizer.load(tok_path) if os.path.exists(tok_path) else None
    seq = cfg.tokenized_sentence_max_length
    if tokenizer is not None:
        ids, mask = tokenizer.encode_batch(SENTENCES, seq)
    else:
        rng = np.random.default_rng(0)
        ids = rng.integers(1, cfg.vocab_size, (3, seq)).astype(np.int32)
        mask = np.ones((3, seq), np.int32)
    ids_t, mask_t = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
    with torch.inference_mode():
        if cfg.model_name == "bagon":
            out = model(ids_t, mask_t, ids_t, mask_t)
        else:
            out = model(ids_t, mask_t)
    recon_ids = torch.argmax(out["logits"], dim=-1).cpu().numpy()
    print(f"checkpoint OK: {cfg.model_name}, logits {tuple(out['logits'].shape)}")
    recons = []
    for i, s in enumerate(SENTENCES):
        recons.append(tokenizer.decode(recon_ids[i]) if tokenizer else str(recon_ids[i]))
        print(f"  {s!r} -> {recons[-1]!r}")
    return recons


if __name__ == "__main__":
    main()
