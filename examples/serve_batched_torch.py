"""End-to-end serving driver on the PyTorch/CUDA port (the paper is an
inference accelerator, so the end-to-end example is batched serving through
the int8 LUT datapath).

Prefill populates the paged int8 KV pool (K/V resident quantized, as in the
CIM array) through the split-softmax prefill kernel; batched decode streams
tokens through the fused paged decode kernel; a continuous-batching
scheduler keeps slots full.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py [--requests 16]
(the reduced tinyllama config; on the card by default, which it needs, or
with ``--device cpu`` on the CPU through the kernels' plain versions)

The counterpart of ``examples/serve_batched.py``: the same arguments to the
port's ``launch.serve.main``, whose record it returns.
"""
import sys

from repro_torch.launch import serve


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return serve.main(["--arch", "tinyllama_1p1b", "--smoke", "--requests",
                       "8", "--slots", "4", "--prompt-len", "32", "--gen",
                       "16"] + argv)


if __name__ == "__main__":
    main()
