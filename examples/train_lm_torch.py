"""Training example on the PyTorch/CUDA port: fakequant (QAT) attention
training with checkpointing, preemption handling and straggler watching —
the production train driver on a configurable model.

Default runs the reduced config for a quick demonstration (on the card,
which it needs; add ``--device cpu`` for the CPU):

    PYTHONPATH=src python examples/train_lm_torch.py

The full TinyLlama-1.1B config at a small batch and sequence, 300 steps:

    PYTHONPATH=src python examples/train_lm_torch.py --full

Resume after interruption (SIGTERM saves the state at the end of the step
it lands in, exit code 143) by re-running the same command: the checkpoint
manager restores params/optimizer/step and the stateless-seeded pipeline
continues the exact token stream.

The counterpart of ``examples/train_lm.py``, with the same two argument
lists to the port's ``launch.train.main``.  Its default checkpoint
directory differs from that example's: the two packages' runs draw other
weights and batches, so one must not resume the other's.
"""
import argparse

from repro_torch.launch import train

CKPT_DIR = "/tmp/cimple_train_ckpt_torch"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the full TinyLlama-1.1B config x 300 steps")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    args, rest = ap.parse_known_args(argv)
    if args.full:
        return train.main(["--arch", "tinyllama_1p1b", "--steps", "300",
                           "--batch", "8", "--seq", "256",
                           "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50"]
                          + rest)
    return train.main(["--arch", "tinyllama_1p1b", "--smoke", "--steps", "60",
                       "--batch", "8", "--seq", "128",
                       "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "20"]
                      + rest)


if __name__ == "__main__":
    main()
