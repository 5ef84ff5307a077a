"""Flagship-quality pipeline on the PyTorch port: Bagon -> k-means codebook
init -> Shelgon3-VQ vq-ft -> decoder adaptation, on the card (``--cpu``: on
the CPU). The twin of ``scripts/flagship_quality.py``: the same flags, gates
(exit 3 and 4) and JSON summary; the pipeline is
``kindergarten_vq_vae_torch/train/flagship.py``.

    python scripts/flagship_quality_torch.py [--bagon-epochs 60] [--vq-epochs 40]
        [--batch 256] [--runs-dir ./runs] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from kindergarten_vq_vae_torch.train.flagship import main  # noqa: E402

if __name__ == "__main__":
    main()
