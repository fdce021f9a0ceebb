"""End-to-end LM training on PyTorch (the twin of ``examples/train_lm.py``):
a ~1M-param OLMo-family model for a few hundred steps with the full
production loop — deterministic pipeline, AdamW, checkpointing, and a
mid-run injected failure that the supervisor recovers from (bit-exact
resume).

    python examples/train_lm_torch.py --steps 200                # on the card
    python examples/train_lm_torch.py --steps 200 --device cpu

Checkpoints go to ``repro_torch_train_lm_ckpt`` under the temporary
directory (``TMPDIR``).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    extra = [] if args.device is None else ["--device", args.device]
    return train_main([
        "--arch", args.arch,
        "--steps", str(args.steps),
        "--supervise",
        "--fail-at", str(max(1, args.steps // 3)),
        "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                   "repro_torch_train_lm_ckpt"),
        "--ckpt-every", "20",
    ] + extra)


if __name__ == "__main__":
    main()
