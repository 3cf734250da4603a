"""Train a small LM end-to-end with the PyTorch port (reduced config of an
assigned arch) with the full substrate: data pipeline, AdamW, gradient
accumulation and remat, checkpointing, straggler monitor. Runs on the
CUDA card; add ``--device cpu`` to run on the CPU.

    PYTHONPATH=src python examples/train_lm_torch.py --arch smollm-360m --steps 200
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    if len(sys.argv) == 1:
        sys.argv += ["--arch", "smollm-360m", "--steps", "200", "--batch", "8",
                     "--seq", "128"]
    main()
