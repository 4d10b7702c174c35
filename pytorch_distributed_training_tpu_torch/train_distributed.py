"""Distributed training CLI of the port (the reference's flags, plus --device).

    python -m pytorch_distributed_training_tpu_torch.train_distributed \\
        --cfg-filepath pytorch_distributed_training_tpu_torch/configs/train-lm-1024.yml \\
        --log-dir run/lm --file-name-cfg lm [--seed 0] [--device cuda|cpu] \\
        [--num-nodes N --rank R --dist-url tcp://HOST:PORT [--multiprocessing]]

Runs on the card unless ``--device cpu`` is given; with no card the default
fails rather than falling back to the CPU.  ``--num-nodes``/``--rank``/
``--dist-url``/``--multiprocessing`` mean what they mean for the reference
(train_distributed.py:38-86): with ``--multiprocessing`` each node spawns
one process per local card; ``torch.distributed`` is initialised from
``--dist-url`` with the world size and rank these give (``--dist-backend``
default: nccl on the card, gloo on the CPU).

A failure inside the run is logged at CRITICAL with its traceback and the
exit code is 1 (the reference logs and exits 0).
"""
from __future__ import annotations

import argparse
import sys
import traceback
from functools import partial

from .config_parsing import get_cfg, get_train_logger
from .engine import Runner
from .logger import MultiProcessLoggerListener
from .utils import make_deterministic

START_METHOD = "spawn"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_training_tpu_torch.train_distributed",
        description="distributed training on CUDA cards (PyTorch port)",
    )
    parser.add_argument("--num-nodes", default=-1, type=int,
                        help="number of nodes for distributed training")
    parser.add_argument("--rank", default=-1, type=int,
                        help="node rank for distributed training")
    parser.add_argument("--dist-url", default="tcp://127.0.0.1:9876", type=str,
                        help="torch.distributed init address")
    parser.add_argument("--dist-backend", default=None, type=str,
                        help="nccl or gloo (default: nccl on cuda, gloo on cpu)")
    parser.add_argument("--seed", default=None, type=int, help="seed for initializing training")
    parser.add_argument("--multiprocessing", action="store_true",
                        help="spawn one process per local card")
    parser.add_argument("--file-name-cfg", type=str, required=True)
    parser.add_argument("--log-dir", type=str, required=True)
    parser.add_argument("--cfg-filepath", type=str, required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    if args.seed is not None:
        print("Set seed:", args.seed)
        make_deterministic(args.seed)
    listener = MultiProcessLoggerListener(
        partial(get_train_logger, args.log_dir, args.file_name_cfg), START_METHOD
    )
    logger = listener.get_logger()
    try:
        runner = Runner(
            num_nodes=args.num_nodes, rank=args.rank, seed=args.seed, dist_url=args.dist_url,
            multiprocessing=args.multiprocessing, logger_queue=listener.queue,
            global_cfg=get_cfg(args.cfg_filepath), device=args.device,
            dist_backend=args.dist_backend,
        )
        logger.info("Starting distributed runner")
        runner()
        return 0
    except Exception as e:  # the reference's crash log (train_distributed.py:76-82)
        logger.critical("While running, exception:\n%s\nTraceback:\n%s", str(e),
                        traceback.format_exc())
        return 1
    finally:
        listener.stop()


if __name__ == "__main__":
    sys.exit(main())
