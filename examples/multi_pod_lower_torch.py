"""Run one (arch x shape) cell on the 512-rank multi-pod mesh and print its
memory/cost/roofline analysis — the single-cell view of what
``python -m repro_torch.launch.dryrun`` sweeps.

Run:  PYTHONPATH=src python examples/multi_pod_lower_torch.py \\
          --arch olmo_1b --shape decode_32k

No card is needed: the step runs eagerly on ``meta`` DTensors over a
``fake`` process group (rank 0 of 512), counting each rank's flops, bytes
and collectives.  The counterpart of ``examples/multi_pod_lower.py``; it
sets no ``XLA_FLAGS`` and takes no ``scan_layers``: the port holds each
layer's weights apart and runs the layers in a Python loop, so scanned
layers have no eager counterpart.
"""
import argparse
import json

from repro_torch.launch.dryrun import dryrun_cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--single-pod", action="store_true")
    args = ap.parse_args(argv)
    report = dryrun_cell(args.arch, args.shape,
                         multi_pod=not args.single_pod)
    print(json.dumps(report, indent=2, default=float))
    return report


if __name__ == "__main__":
    main()
