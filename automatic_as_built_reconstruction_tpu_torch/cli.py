"""Command line of the port, with the reference's argument names.

    python -m automatic_as_built_reconstruction_tpu_torch.cli train \
        --config_path=... --model_dir=... [--max_steps N] [--no-resume]
    python -m automatic_as_built_reconstruction_tpu_torch.cli evaluate \
        --config_path=... --model_dir=... [--output_dir D]
    python -m automatic_as_built_reconstruction_tpu_torch.cli \
        kitti_data_prep --root_path=...

Every verb that runs a network takes ``--device`` (``cuda`` by default;
``cpu`` only when asked for).  ``train`` and ``evaluate`` take
``--num_devices N``: data parallel over N ranks, which the command starts
itself, or, under ``torchrun --nproc_per_node N``, the ranks torchrun
started.  The reference's other verbs
(``building_data_prep``, ``import_torch_weights``, ``export_serving``,
``export_asbuilt``, ``viewer``) and ``train --profile_steps`` are not
ported.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(prog="abr_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a model from a config")
    p_train.add_argument("--config_path", required=True)
    p_train.add_argument("--model_dir", required=True)
    p_train.add_argument("--max_steps", type=int, default=None)
    p_train.add_argument("--display_step", type=int, default=50)
    p_train.add_argument("--seed", type=int, default=0)
    p_train.add_argument("--no-resume", dest="resume", action="store_false")
    p_train.add_argument("--num_devices", type=int, default=None,
                         help="data-parallel ranks (the first N cards, or "
                              "N CPU ranks with --device cpu)")
    p_train.add_argument("--device", default="cuda")

    p_eval = sub.add_parser("evaluate", help="evaluate latest checkpoint")
    p_eval.add_argument("--config_path", required=True)
    p_eval.add_argument("--model_dir", required=True)
    p_eval.add_argument("--ckpt_step", type=int, default=None)
    p_eval.add_argument("--output_dir", default=None)
    p_eval.add_argument("--measure_time", action="store_true")
    p_eval.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel ranks (the first N cards, or "
                             "N CPU ranks with --device cpu)")
    p_eval.add_argument("--device", default="cuda")

    p_kprep = sub.add_parser("kitti_data_prep",
                             help="build KITTI infos, reduced clouds, "
                                  "gt database")
    p_kprep.add_argument("--root_path", required=True)

    args = parser.parse_args(argv)

    if args.command == "train":
        from .train.train import train
        train(args.config_path, args.model_dir, resume=args.resume,
              max_steps=args.max_steps, display_step=args.display_step,
              seed=args.seed, num_devices=args.num_devices,
              device=args.device)
    elif args.command == "evaluate":
        from .train.train import evaluate
        result = evaluate(args.config_path, args.model_dir,
                          ckpt_step=args.ckpt_step,
                          output_dir=args.output_dir,
                          measure_time=args.measure_time,
                          num_devices=args.num_devices, device=args.device)
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_rank() != 0:
            return      # under torchrun rank 0 prints the result
        if "result_str" in result:
            print(result["result_str"])
        else:
            for k, v in sorted(result.items()):
                if isinstance(v, (int, float)):
                    print(f"{k}: {v:.4f}")
    elif args.command == "kitti_data_prep":
        from .data.create_data import kitti_data_prep
        kitti_data_prep(args.root_path)


if __name__ == "__main__":
    main()
