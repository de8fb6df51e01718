"""Training / prediction CLI (port of reflectance_filtering_tpu/cli/train.py,
the rebuild of the reference's training/train_with_barrista.py).

    python -m reflectance_filtering_tpu_torch.cli.train --stage=fit \\
        --iterations=... --data_root <LMDBs> --results_root <Results> \\
        [--device cuda|cpu]

The same flag set, results tree (images logs networks progressions scores
framerates snapshots decompositions_linear decompositions_sRGB) and
experiment lifecycle as the JAX package: fit -> a checkpoint every
--checkpoint_interval samples with the live val WHDR -> the final and every
intermediate snapshot scored on the val split -> progressions/*.json;
predict -> hyperparameters recovered from the checkpoint filename -> score
the val split.  Checkpoints are the JAX package's .npz layout, so either
package resumes or scores the other's.  ``--device`` (default cuda) picks
the card, where the flagship's trunk runs the fused kernel K7 and the WHDR
hinge K3/K8; without a GPU the CLI exits and asks for ``--device cpu``.

Not ported yet, each refused with a message: ``--decompose`` (ROADMAP
module queue item 12), ``--profile_dir`` (a tracing PR, item 5); the
network-graph PNG of models/draw.py is skipped (item 11).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import timeit

from ..data.loader import get_data
from ..models.networks import (NetworkConfig, matmul_precision,
                               params_to_numpy, params_to_torch)
from ..train.checkpoint import Checkpointer, load_checkpoint
from ..train.description import get_description, parse_description
from ..train.loop import LossConfig, fit, make_val_whdr_fn
from ..train.monitors import (CombineLosses, FilterVisualizer, JsonlLogger,
                              ProgressPrinter, RunningAverage)
from ..train.predict import make_predict_fn, predict_and_score
from . import add_device_flag, resolve_device

FLAGS_FIT = ["fit", "f", "train"]
FLAGS_PREDICT = ["predict", "p", "test", "val"]

RESULT_SUBDIRS = ["images", "logs", "networks", "progressions", "scores",
                  "framerates", "snapshots", "decompositions_linear",
                  "decompositions_sRGB"]


def build_parser():
    parser = argparse.ArgumentParser(
        description="Parses the arguments and then runs the appropriate mode.")
    add = parser.add_argument
    add("--stage", "-s", dest="stage", help="fit or predict")
    add("--iterations", "-i", type=int,
        help="number of iterations to train or with which trained iteration "
             "to predict")
    add("--solver", dest="solverType", default="ADAM", help="ADAM or SGD")
    add("--base_lr", "-lr", dest="base_lr", type=float, default=0.001)
    add("--comparisonsType", "-comp", dest="comparisonsType",
        default="comparisons", choices=["comparisons", "augmented"])
    add("--networkType", "-net", dest="networkType",
        default="convStaticWithSigmoid",
        choices=["uNet", "simpleConvolutionsRelu", "convStatic",
                 "convIncreasing", "convStaticWithSigmoid",
                 "convStaticSkipLayers", "cascadeSkipLayers"])
    add("--loss_scale_whdr", type=float, default=10)
    add("--loss_scale_lambert", type=float, default=0.0)
    add("--shading_unary_type", default="L1_0.5")
    add("--loss_scale_boundaries01", type=float, default=0.1)
    add("--batch_size", "-b", dest="batch_size", type=int, default=20)
    add("--predictCaffemodel", "-pcm", dest="predictCaffemodel", default=None,
        help="to directly predict for a certain checkpoint")
    # default None: predict mode tells "user said 256" from "user said
    # nothing" (an explicit flag beats the checkpoint-name parse)
    add("--height", type=int, default=None)
    add("--width", type=int, default=None)
    add("--startOver", type=int, default=1)
    add("--alwaysComputeShadingLosses", type=int, default=0)
    add("--numLayers", dest="numLayers", type=int, default=2)
    add("--RS_est_mode", "-RS", dest="RS_est_mode", default="rRelMax",
        choices=["sAbs", "S", "rAbs", "R", "RS",
                 "rRelNorm", "rRelMean", "rRelY", "rRelMax",
                 "sRelNorm", "sRelMean", "sRelY", "sRelMax", "rDirectly"])
    add("--kernel_pad", type=int, default=1)
    add("--num_filters_log", type=int, default=4)
    add("--use_batch_normalization", type=int, default=0)
    add("--checkpoint_interval", type=int, default=1000)
    add("--experiment", "-exp", dest="experiment_name", default="tmp")
    add("--random_seed", type=int, default=-1)
    add("--dataset", default="iiw",
        choices=["iiw", "sintel", "mixed", "nonsense"])
    add("--sRGB_linear", default="linear", choices=["sRGB", "linear"])
    add("--whdr_delta_margin_ratio_dense", default="0.1_0.05_1.0_1")
    add("--test", type=int, default=0)
    add("--dilation", type=int, default=1)
    add("--matmul_precision", default="highest",
        choices=["default", "high", "highest"],
        help="float32 matmul precision of the plain per-layer path "
             "('high'/'default': TF32 on the card); the fused trunk kernel "
             "always runs full float32")
    add("--decompose", action="append",
        help="decompose images in a folder or a video (not ported yet)")
    add("--data_root", default=os.path.join(os.path.expanduser("~"), "LMDBs"))
    add("--results_root",
        default=os.path.join(os.path.expanduser("~"), "Results"))
    add("--profile_dir", default=None,
        help="device trace of the fit stage (not ported yet)")
    add_device_flag(parser)
    return parser


def net_config_from_args(args) -> NetworkConfig:
    return NetworkConfig(
        network_type=args.networkType,
        num_layers=args.numLayers,
        num_filters_log=args.num_filters_log,
        kernel_pad=args.kernel_pad,
        dilation=args.dilation,
        use_batch_normalization=bool(args.use_batch_normalization),
        rs_est_mode=args.RS_est_mode,
    )


def loss_config_from_args(args) -> LossConfig:
    return LossConfig(
        loss_scale_whdr=args.loss_scale_whdr,
        loss_scale_lambert=args.loss_scale_lambert,
        loss_scale_boundaries01=args.loss_scale_boundaries01,
        shading_unary_type=args.shading_unary_type,
        whdr_delta_margin_ratio_dense=args.whdr_delta_margin_ratio_dense,
    )


def _existing_snapshots(snapshot_dir: str, description: str):
    """Sorted sample counts of on-disk snapshots for a description."""
    pat = re.compile(re.escape(description) + r"_barrista_iter_(\d+)\.npz$")
    if not os.path.isdir(snapshot_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(snapshot_dir)
                  for m in [pat.match(f)] if m)


def _load_params_any(path: str, device):
    """Params from a .npz checkpoint (either package's) or a .caffemodel,
    as the port's tensors on ``device``."""
    if path.endswith(".caffemodel"):
        from ..models.caffe_io import load_reference_weights
        return params_to_torch(load_reference_weights(path), device)
    params, _, _ = load_checkpoint(path)
    return params_to_torch(params, device)


def fit_predict_net(args, results_dir: str, device):
    """The experiment lifecycle (helper:141-439)."""
    if args.stage in FLAGS_PREDICT and not args.predictCaffemodel:
        raise ValueError(
            "--stage=predict requires --predictCaffemodel "
            "(the checkpoint to predict with)")
    if args.stage in FLAGS_PREDICT and args.predictCaffemodel:
        # hyperparameters from the checkpoint filename first, so the
        # description, the val-data resolution and the network all match it
        try:
            parsed = parse_description(
                os.path.basename(args.predictCaffemodel))
        except (ValueError, IndexError):
            parsed = {}
            print("Checkpoint name encodes no config; using CLI args.")
        for k, v in parsed.items():
            if k in ("height", "width") and getattr(args, k) is not None:
                continue  # an explicit CLI size beats the checkpoint's
            setattr(args, k, v)
        if parsed:
            print("Inferred parameters:", parsed)
    if args.height is None:
        args.height = 256
    if args.width is None:
        args.width = 256
    net_params, description = get_description(args)
    snapshot_dir = os.path.join(results_dir, "snapshots")
    additional_info = "_{}_{}_{}".format(args.height, args.width,
                                         args.sRGB_linear)

    def getData(desc):
        return get_data(args.dataset, desc + additional_info,
                        args.comparisonsType, root=args.data_root)

    if args.stage not in FLAGS_FIT + FLAGS_PREDICT:
        raise ValueError(
            "stage '{}' is currently not implemented!".format(args.stage))
    if args.dataset in ("sintel", "mixed"):
        # the reference's WHDR layers ignore the albedos bottom, so its
        # sintel mode silently trains on nothing; refuse instead
        raise NotImplementedError(
            "--dataset={} is not supported: the reference never shipped "
            "the albedo-to-comparisons generation its sintel mode needs "
            "(its WHDR layers ignore the albedos bottom), so training "
            "would silently optimize nothing. Use --dataset=iiw.".format(
                args.dataset))

    print("Descriptive string:", description)
    net_cfg = net_config_from_args(args)
    loss_cfg = loss_config_from_args(args)

    os.makedirs(os.path.join(results_dir, "networks"), exist_ok=True)
    with open(os.path.join(results_dir, "networks",
                           net_params + ".json"), "w") as f:
        json.dump({"network_config": net_cfg.__dict__,
                   "loss_config": loss_cfg.__dict__}, f, indent=2)
    print("network graph PNG skipped: models/draw.py is not ported yet "
          "(ROADMAP module queue item 11)", file=sys.stderr)

    iterations = args.iterations
    if iterations is None:
        if args.stage in FLAGS_FIT:
            raise ValueError("Number of iterations was not set!")
        iterations = 1

    # the training blob loads lazily: a --startOver=0 re-invocation whose
    # checkpoint already covers the requested iterations never touches it
    load_X = None
    X_val = None
    if not args.test:
        if args.stage in FLAGS_FIT:
            load_X = lambda: getData("trainValTest_train")  # noqa: E731
        X_val = getData("trainValTest_val")
    else:
        if args.stage in FLAGS_FIT:
            load_X = lambda: getData("bigTrainMiniValTest_train")  # noqa
            X_val = getData("bigTrainMiniValTest_val")
        elif args.stage in FLAGS_PREDICT:
            X_val = getData("trainValTest_test")

    if args.stage in FLAGS_FIT:
        if iterations < args.batch_size:
            raise ValueError(
                "iterations ({}) < batch_size ({}): zero training steps "
                "would run and no checkpoint would exist to evaluate".format(
                    iterations, args.batch_size))
        # snapshots happen on batch boundaries: round the interval down to a
        # batch multiple
        checkpoint_interval = min(args.checkpoint_interval, iterations)
        effective = max(args.batch_size,
                        (checkpoint_interval // args.batch_size)
                        * args.batch_size)
        if effective != checkpoint_interval:
            print("checkpoint_interval", checkpoint_interval,
                  "is not a multiple of batch_size; using", effective)
        checkpoint_interval = effective
        print("Checkpointing every", checkpoint_interval, "iterations.")
        checkptr = Checkpointer(snapshot_dir, description,
                                checkpoint_interval)

        # startOver=1: from scratch (optionally warm-started from
        # --predictCaffemodel); startOver=0: resume from the highest
        # snapshot (params, optimizer state, data cursor, host selection)
        init_params = None
        init_opt_state = None
        base_samples = 0
        run_training = True
        if args.startOver:
            if args.predictCaffemodel:
                print("Load initial weights from:", args.predictCaffemodel)
                init_params = _load_params_any(args.predictCaffemodel, device)
        else:
            base_samples = checkptr.highest_iteration()
            if base_samples == 0:
                print("No previously trained net found, "
                      "starting from scratch.")
            elif base_samples >= iterations:
                print("Found checkpoint at iteration", base_samples,
                      ">= requested", iterations, "- skipping training.")
                run_training = False
            else:
                cpath = checkptr.path(base_samples)
                init_params, init_opt_state, _ = load_checkpoint(cpath)
                if init_opt_state is None and args.solverType.upper() != "SGD":
                    raise ValueError(
                        "checkpoint {} has no optimizer state; cannot "
                        "resume".format(cpath))
                print("Continuing from iteration", base_samples,
                      "with file", cpath)

        if run_training:
            if args.profile_dir:
                raise NotImplementedError(
                    "--profile_dir is not ported yet (ROADMAP module queue "
                    "item 5: a tracing PR)")
            X = load_X()
            callbacks = [CombineLosses(args.loss_scale_whdr,
                                       args.loss_scale_lambert),
                         RunningAverage(X["images"].shape[0],
                                        args.batch_size),
                         JsonlLogger(os.path.join(results_dir, "logs"),
                                     description + "_" + str(iterations))]
            progress = ProgressPrinter(iterations, args.loss_scale_whdr,
                                       args.loss_scale_boundaries01,
                                       args.loss_scale_lambert)
            visualize = FilterVisualizer(results_dir)
            start_train = timeit.default_timer()
            print("Starting the training for", iterations, "iterations.")
            sys.stdout.flush()
            val_fn = (make_val_whdr_fn(net_cfg, X_val, args.batch_size,
                                       device)
                      if X_val is not None else None)
            with matmul_precision(args.matmul_precision):
                fit(net_cfg, loss_cfg, X, iterations, args.batch_size,
                    args.solverType, args.base_lr, args.random_seed,
                    args.comparisonsType, init_params=init_params,
                    init_opt_state=init_opt_state,
                    base_samples=base_samples,
                    callbacks=callbacks, checkpointer=checkptr,
                    progress=progress,
                    on_checkpoint=lambda samples, params: visualize(
                        samples, params_to_numpy(params)),
                    val_fn=val_fn, device=device)
            callbacks[-1].close()
            training_time = timeit.default_timer() - start_train
            print("Total training time is", training_time)

        # evaluate the final and every intermediate checkpoint
        predict_fn = make_predict_fn(net_cfg)

        def eval_checkpoint(samples):
            cname = "{}_barrista_iter_{}.npz".format(description, samples)
            params = _load_params_any(os.path.join(snapshot_dir, cname),
                                      device)
            return predict_and_score(
                X_val, params, net_cfg, results_dir, cname[:-4],
                batch_size=args.batch_size, predict_fn=predict_fn,
                device=device)

        if run_training:
            # the snapshots actually written (plus earlier runs' of the same
            # description): a resume with another batch size walks off the
            # old sample grid
            intermediates = sorted(
                set(checkptr.created)
                | set(_existing_snapshots(snapshot_dir, description)))
        else:
            intermediates = _existing_snapshots(snapshot_dir, description)
            if not intermediates:
                raise FileNotFoundError(
                    "no snapshots found in {} for description {}".format(
                        snapshot_dir, description))
        final_samples = intermediates[-1]

        print("Now predict data from val and evaluate the WHDR on it.")
        score = eval_checkpoint(final_samples)

        print("Test all intermediate caffemodels.")
        json_val = []
        scores = []
        for i in intermediates:
            val_score = eval_checkpoint(i)
            json_val.append({"NumIters": i, "WHDR": val_score})
            scores.append(val_score)
            print("Ran iteration", i, "of", iterations,
                  "with validation score", val_score)
            sys.stdout.flush()

        os.makedirs(os.path.join(results_dir, "progressions"), exist_ok=True)
        with open(os.path.join(results_dir, "progressions",
                               "barrista_" + description + ".json"),
                  "w") as f:
            json.dump({"test": json_val, "train": []}, f)
        print("Final score in % (the best one):")
        print(min(scores) if scores else score)

    if args.predictCaffemodel and args.stage in FLAGS_PREDICT:
        params = _load_params_any(args.predictCaffemodel, device)
        if X_val is not None:
            predict_and_score(X_val, params, net_cfg, results_dir,
                              os.path.splitext(os.path.basename(
                                  args.predictCaffemodel))[0],
                              batch_size=args.batch_size, device=device)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    device = resolve_device(parser, args.device)
    if args.decompose:
        raise NotImplementedError(
            "--decompose is not ported yet (ROADMAP module queue item 12: "
            "the predict/decompose family); use "
            "reflectance_filtering_tpu_torch.cli.decompose for photos")
    print("Arguments:")
    print(vars(args))
    results_dir = os.path.join(args.results_root, args.experiment_name)
    for d in RESULT_SUBDIRS:
        os.makedirs(os.path.join(results_dir, d), exist_ok=True)
    fit_predict_net(args, results_dir, device)


if __name__ == "__main__":
    main()
