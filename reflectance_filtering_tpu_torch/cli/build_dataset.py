"""Dataset-build CLI (port of reflectance_filtering_tpu/cli/build_dataset.py)
— the reference's createNumpyArrayWithComparisonsForIIW edit-the-constants
workflow (createNumpy...:50-89, 731-843) exposed as flags.

Modes mirror the reference's CREATE list: one, dummy, trainTest,
trainValTest, bigTrainMiniValTest, all, allShuffled.  Host code (numpy, the
image decode and resize): it has no --device flag.

  python -m reflectance_filtering_tpu_torch.cli.build_dataset \\
      --data_folder iiw-dataset/data --save_to LMDBs/iiw \\
      --mode trainValTest [--height 256 --width 256 --augment 1 --workers 8]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import builder as B


def run_mode(mode: str, data_folder: str, save_to: str,
             height: int, width: int, augment_data: bool,
             seed: int = 0, workers: int = 1):
    os.makedirs(save_to, exist_ok=True)
    names = B.sorted_file_list(data_folder)
    if not names:
        raise IOError("No {} files found in {}".format(
            B.IMAGE_EXTENSION, data_folder))

    def build(file_list, stem):
        B.build_dataset(data_folder, file_list,
                        os.path.join(save_to, stem),
                        height=height, width=width,
                        augment_data=augment_data, seed=seed,
                        workers=workers)

    if mode == "dummy":                   # createNumpy...:752-767
        file_list = names[:20]
        build(file_list[:10], "dummy_val")
        build(file_list[10:], "dummy_train")
    elif mode == "one":                   # createNumpy...:768-777
        build(names[:1], "one_train")
        build(names[1:2] or names[:1], "one_test")
        build(names[:2], "two_train")
        build(names[:2], "two_test")
    elif mode == "all":
        build(names, "all")
    elif mode == "allShuffled":
        shuffled = list(names)
        np.random.RandomState(seed).shuffle(shuffled)
        build(shuffled, "allShuffled")
    elif mode == "trainTest":
        train, test = B.narihira_split_two(names)
        build(train, "train")
        build(test, "test")
    elif mode == "trainValTest":
        train, val, test = B.narihira_split_three(names)
        build(train, "trainValTest_train")
        build(val, "trainValTest_val")
        build(test, "trainValTest_test")
    elif mode == "bigTrainMiniValTest":
        train, val, test = B.big_train_mini_val_split(names)
        build(train, "bigTrainMiniValTest_train")
        build(val, "bigTrainMiniValTest_val")
        build(test, "bigTrainMiniValTest_test")
    else:
        raise ValueError(
            "mode was {} but should be one of: one, dummy, trainTest, "
            "trainValTest, bigTrainMiniValTest, all, allShuffled".format(mode))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Build packed .npz shards from an IIW-style folder of "
                    "PNG images + JSON judgments.")
    parser.add_argument("--data_folder", required=True,
                        help="folder with <id>.png and <id>.json files")
    parser.add_argument("--save_to", required=True,
                        help="output folder for the .npz shards")
    parser.add_argument("--mode", default="trainValTest",
                        choices=["one", "dummy", "trainTest", "trainValTest",
                                 "bigTrainMiniValTest", "all", "allShuffled"])
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--augment", type=int, default=0,
                        help="add the transitive closure of comparisons")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--workers", type=int, default=1,
                        help="process-pool width for the per-file build "
                             "(race-free, deterministic; the reference's "
                             "parallel mode corrupts output)")
    args = parser.parse_args(argv)
    run_mode(args.mode, args.data_folder, args.save_to,
             args.height, args.width, bool(args.augment), args.seed,
             workers=args.workers)


if __name__ == "__main__":
    main()
