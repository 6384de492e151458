"""Command line of the port, with the reference's verbs and argument
names.

    python -m automatic_as_built_reconstruction_tpu_torch.cli train \
        --config_path=... --model_dir=... [--max_steps N] [--no-resume] \
        [--profile_steps N]
    python -m automatic_as_built_reconstruction_tpu_torch.cli evaluate \
        --config_path=... --model_dir=... [--output_dir D]
    python -m automatic_as_built_reconstruction_tpu_torch.cli \
        building_data_prep --root_path=... [--num_scenes N] \
        [--scan_dir DIR [--val_fraction F]]
    python -m automatic_as_built_reconstruction_tpu_torch.cli \
        kitti_data_prep --root_path=...
    python -m automatic_as_built_reconstruction_tpu_torch.cli \
        import_torch_weights --config_path=... --model_dir=... \
        --torch_ckpt=voxelnet.tckpt [--no-strict]
    python -m automatic_as_built_reconstruction_tpu_torch.cli \
        export_serving --config_path=... --model_dir=... \
        --output=model.abr [--platforms cuda|cpu] [--batch 8] ...
    python -m automatic_as_built_reconstruction_tpu_torch.cli \
        export_asbuilt --config_path=... --model_dir=... --scene 0 \
        --output=model.json [--svg plan.svg]
    python -m automatic_as_built_reconstruction_tpu_torch.cli viewer \
        --config_path=... [--model_dir=...] [--port 8123]

Every verb that runs a network takes ``--device`` (``cuda`` by default;
``cpu`` only when asked for); ``export_serving`` exports on the device
``--platforms`` names (``cuda`` by default).  ``train`` and ``evaluate``
take ``--num_devices N``: data parallel over N ranks, which the command
starts itself, or, under ``torchrun --nproc_per_node N``, the ranks
torchrun started.  ``train --profile_steps N`` writes a trace of N steps
after two warm-up steps under ``<model_dir>/profile``.
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
    p_train.add_argument("--profile_steps", type=int, default=0,
                         help="capture a torch.profiler trace of N steps "
                              "to <model_dir>/profile")
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

    p_bprep = sub.add_parser("building_data_prep",
                             help="generate synthetic building scans + infos"
                                  " + gt database, or ingest real scans via"
                                  " --scan_dir (ply/pcd/bin/npz + JSON"
                                  " box sidecars)")
    p_bprep.add_argument("--root_path", required=True)
    p_bprep.add_argument("--num_scenes", type=int, default=128)
    p_bprep.add_argument("--num_val", type=int, default=32)
    p_bprep.add_argument("--seed", type=int, default=0)
    p_bprep.add_argument("--scan_dir", default=None,
                         help="directory of real scans to ingest instead "
                              "of generating synthetic scenes")
    p_bprep.add_argument("--val_fraction", type=float, default=0.2)

    p_kprep = sub.add_parser("kitti_data_prep",
                             help="build KITTI infos, reduced clouds, "
                                  "gt database")
    p_kprep.add_argument("--root_path", required=True)

    p_imp = sub.add_parser(
        "import_torch_weights",
        help="convert a lineage torch checkpoint (.tckpt/.pt) into this "
             "trainer's checkpoint at step 0 under --model_dir")
    p_imp.add_argument("--config_path", required=True)
    p_imp.add_argument("--model_dir", required=True)
    p_imp.add_argument("--torch_ckpt", required=True)
    p_imp.add_argument("--no-strict", dest="strict", action="store_false",
                       help="skip missing keys instead of raising")

    p_exp = sub.add_parser(
        "export_serving",
        help="export the full serving program (voxelize -> model -> "
             "decode+NMS, weights inside) as a torch.export artifact")
    p_exp.add_argument("--config_path", required=True)
    p_exp.add_argument("--model_dir", required=True)
    p_exp.add_argument("--output", required=True)
    p_exp.add_argument("--batch", type=int, default=8)
    p_exp.add_argument("--max_points", type=int, default=60000)
    p_exp.add_argument("--platforms", default="cuda", choices=("cuda", "cpu"),
                       help="the device the program is exported on")
    p_exp.add_argument("--max_voxels", type=int, default=20000)
    p_exp.add_argument("--max_points_per_voxel", type=int, default=32)
    p_exp.add_argument("--voxelization", default="hard",
                       choices=("hard", "dynamic", "fused_mean"))

    p_abx = sub.add_parser(
        "export_asbuilt",
        help="run inference on an eval scene and export the reconstructed "
             "as-built model (merged wall runs, columns, door openings) "
             "as JSON [+ SVG floor plan]")
    p_abx.add_argument("--config_path", required=True)
    p_abx.add_argument("--model_dir", required=True)
    p_abx.add_argument("--scene", type=int, default=0,
                       help="eval-split scene index")
    p_abx.add_argument("--output", required=True, help="JSON output path")
    p_abx.add_argument("--svg", default=None,
                       help="optional SVG floor-plan output path")
    p_abx.add_argument("--score_threshold", type=float, default=0.3)
    p_abx.add_argument("--device", default="cuda")

    p_view = sub.add_parser("viewer", help="serve the web viewer")
    p_view.add_argument("--config_path", required=True)
    p_view.add_argument("--model_dir", default=None)
    p_view.add_argument("--port", type=int, default=8123)
    p_view.add_argument("--device", default="cuda")

    args = parser.parse_args(argv)

    if args.command == "train":
        from .train.train import train
        train(args.config_path, args.model_dir, resume=args.resume,
              max_steps=args.max_steps, display_step=args.display_step,
              seed=args.seed, num_devices=args.num_devices,
              profile_steps=args.profile_steps, device=args.device)
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
    elif args.command == "building_data_prep":
        if args.scan_dir:
            from .data.create_data import building_data_prep_from_scans
            building_data_prep_from_scans(args.scan_dir, args.root_path,
                                          val_fraction=args.val_fraction)
        else:
            from .data.create_data import building_data_prep
            building_data_prep(args.root_path, num_scenes=args.num_scenes,
                               num_val=args.num_val, seed=args.seed)
    elif args.command == "kitti_data_prep":
        from .data.create_data import kitti_data_prep
        kitti_data_prep(args.root_path)
    elif args.command == "import_torch_weights":
        from .train.train import import_torch_weights
        import_torch_weights(args.config_path, args.model_dir,
                             args.torch_ckpt, strict=args.strict)
        print(f"imported {args.torch_ckpt} -> {args.model_dir} (step 0)")
    elif args.command == "export_serving":
        from .utils.serving_export import export_serving_from_checkpoint
        size, meta = export_serving_from_checkpoint(
            args.config_path, args.model_dir, args.output,
            batch=args.batch, max_points=args.max_points,
            platforms=(args.platforms,), max_voxels=args.max_voxels,
            max_points_per_voxel=args.max_points_per_voxel,
            voxelization=args.voxelization)
        print(f"wrote {args.output} ({size} bytes): {meta}")
    elif args.command == "export_asbuilt":
        from .utils.asbuilt_export import export_asbuilt
        from .viewer.server import _make_predictor
        dataset, predict = _make_predictor(args.config_path, args.model_dir,
                                           device=args.device)
        dets = predict(args.scene)
        class_names = getattr(dataset, "_class_names",
                              ("wall", "column", "door"))
        model = export_asbuilt(
            {"box3d_lidar": dets["boxes"], "scores": dets["scores"],
             "label_preds": dets["labels"]},
            class_names, json_path=args.output, svg_path=args.svg,
            score_threshold=args.score_threshold)
        print(f"wrote {args.output}: {model['stats']}")
    elif args.command == "viewer":
        from .viewer.server import main as viewer_main
        argv2 = ["--config_path", args.config_path, "--port", str(args.port),
                 "--device", args.device]
        if args.model_dir:
            argv2 += ["--model_dir", args.model_dir]
        viewer_main(argv2)


if __name__ == "__main__":
    main()
