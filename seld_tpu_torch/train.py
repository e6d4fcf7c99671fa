"""Config-file-driven training CLI of the port, with the root ``train.py``'s
surface:

    python -m seld_tpu_torch.train --TextArgs=config/DQSELD-TCN-S1-PHI_8ch.txt \
        [--key=value ...] [--max_epochs=N] [--device=cpu]

Every ``--key=value`` flag of the reference's argparse surface is accepted,
in the text config and on the command line (the command line wins); unknown
keys are warned about and ignored. ``--frontend_impl=pallas-ct`` runs every
CNN stage on a kernel in training (K5, then K9). It trains on the CUDA card
unless ``--device=cpu`` asks for the CPU, and prints the same RESULTS block.
A ``training_predictors_path`` ending in ``.seldpak`` trains from that
container (``seld_tpu_torch.data.native.pack_dataset`` writes one).

Several processes train as the ranks of one data axis when the launcher sets
the JAX package's variables, ``JAX_COORDINATOR_ADDRESS`` (``host:port`` of
rank 0), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``: one process a device,
``nccl`` on the card and ``gloo`` on the CPU, or ``--dist_backend``
(``gloo`` puts several ranks on one card).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--TextArgs", type=str, default=None,
                        help="Path to a text config with --key=value lines")
    parser.add_argument("--max_epochs", type=int, default=None,
                        help="Hard epoch cap (default: the reference's early stopping only)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to train on (default cuda; cpu for the CPU)")
    parser.add_argument("--dist_backend", type=str, default=None,
                        help="torch.distributed backend of a multi-process run (default "
                             "nccl on cuda, gloo on cpu)")
    args, extra = parser.parse_known_args(argv)

    from seld_tpu_torch.parallel import multihost

    # the JAX_* variables, as the JAX CLI reads them; a single-process no-op.
    # Before anything touches the card: it picks this process's device
    if multihost.initialize(device=args.device, backend=args.dist_backend):
        rank, world = multihost.process_info()
        print(f"multihost: process {rank}/{world} on {multihost.local_device(args.device)}")

    from seld_tpu_torch.config import load_config, tokens_to_config
    from seld_tpu_torch.training.trainer import Trainer

    cfg = load_config(args.TextArgs)
    if extra:
        cfg = tokens_to_config(extra, base=cfg)
    try:
        results = Trainer(cfg, device=multihost.local_device(args.device)).run(
            max_epochs=args.max_epochs)
    finally:
        multihost.shutdown()
    print("RESULTS")
    for key, val in results.items():
        if "hist" not in key:
            print(key, val)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
