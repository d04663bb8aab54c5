"""Command-line option registry. Counterpart of
``m4depth_tpu/cli/options.py``.

Every flag name of the JAX CLI is kept, so its shell scripts run with the
module path changed. ``--platform`` takes ``cpu`` or ``gpu`` (empty means
``gpu``). The flags that only choose among TPU implementations of one
function (``TPU_ONLY``) are accepted; the port has one implementation of
each, and a value other than the default prints one line saying so. So do
the flags that the JAX CLI accepts and reads nowhere (``UNUSED``).
"""

from __future__ import annotations

import argparse
import os

import torch

from m4depth_tpu_torch import resolve_device
from m4depth_tpu_torch.config import (
    AblationFlags,
    ModelConfig,
    TrainConfig,
    load_dataset_locations,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# flags of the JAX CLI that choose among its TPU formulations
TPU_ONLY = ("dscv_impl", "dscv_row_group", "dscv_x_window", "dscv_xw_dual",
            "dscv_chunk_bytes", "dscv_bwd", "sncv_impl", "time_axis",
            "scan_unroll", "disable_xla")
# flags of the JAX CLI that it accepts for the reference's scripts and reads
# nowhere (it saves every epoch)
UNUSED = ("save_interval", "conf_err_rate")


def build_parser(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    g = parser
    g.add_argument("--dataset", default="",
                   choices=["midair", "tartanair", "kitti-raw"],
                   help="Dataset to use")
    g.add_argument("--platform", default="", choices=["", "cpu", "gpu"],
                   help="Device to run on: gpu (the default; raises "
                        "without a CUDA device) or cpu (the kernels' plain "
                        "PyTorch versions)")
    g.add_argument("--ckpt_dir", default="ckpt",
                   help="Model checkpoint directory")
    g.add_argument("--mode",
                   choices=["train", "finetune", "eval", "validation",
                            "predict", "convert", "promote"],
                   help="Run mode (convert: decode the CSV dataset once "
                        "into a binary record store; promote: re-save "
                        "ckpt_dir/best's ledger winner under "
                        "promote_dest/train so finetuning resumes from it)")
    g.add_argument("--promote_dest", default=None, type=str,
                   help="promote mode: destination checkpoint dir "
                        "(defaults to --ckpt_dir, promoting in place)")
    g.add_argument("--record_store", default=None, type=str,
                   help="Path to a record store. With --mode=convert: the "
                        "output directory. Other modes: train/eval from the "
                        "store (mmap windows, numpy alone) instead of "
                        "decoding JPEG/PNG per epoch")
    g.add_argument("--db_path_config",
                   default=os.path.join(REPO_ROOT, "datasets_location.json"),
                   help="Json file with datasets path configuration")
    g.add_argument("--batch_size", default=3, type=int)
    g.add_argument("--records_path", default=None, type=str,
                   help="csv manifests to use when loading the dataset")
    g.add_argument("--db_seq_len", default=None, type=int,
                   help="Dataset sequence length (mandatory for training)")
    g.add_argument("--seq_len", default=4, type=int,
                   help="Sequence length fed to the network")
    g.add_argument("--log_dir", default=None)
    g.add_argument("--summary_interval", default=1200, type=int)
    g.add_argument("--save_interval", default=2, type=int)
    g.add_argument("--no_augmentation", default=False, action="store_true")
    g.add_argument("--augment_device", default=False, action="store_true",
                   help="augment on the device inside the train step "
                        "(data/augment_device.py) instead of with numpy on "
                        "the loader's threads")
    # accepted for the reference's scripts; unused there too
    g.add_argument("--conf_err_rate", default=0.05, type=float,
                   help=argparse.SUPPRESS)
    g.add_argument("--disable_xla", default=False, action="store_true",
                   help=argparse.SUPPRESS)
    g.add_argument("--enable_validation", default=False, action="store_true")
    g.add_argument("--keep_top_n", default=1, type=int)
    # Ablations
    g.add_argument("--arch_depth", default=6, type=int)
    g.add_argument("--no_DINL", default=False, action="store_true")
    g.add_argument("--no_SNCV", default=False, action="store_true")
    g.add_argument("--no_time_recurr", default=False, action="store_true")
    g.add_argument("--no_feature_normalization", default=False,
                   action="store_true")
    g.add_argument("--no_feature_subdivision", default=False,
                   action="store_true")
    g.add_argument("--no_level_memory", default=False, action="store_true")
    g.add_argument("--model", default="m4depth",
                   choices=["m4depth", "m4depth-v1"],
                   help="Model family: the Sensors-2022 M4Depth, or the "
                        "legacy V1 (arXiv 2021)")
    g.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    g.add_argument("--cv_dtype", default="bfloat16",
                   choices=["float32", "bfloat16", "float16"],
                   help="Dtype the cost-volume inputs are rounded to (the "
                        "reference hard-coded float16, "
                        "depth_operations.py:276-278)")
    # the JAX CLI's TPU formulations: accepted, one implementation here
    g.add_argument("--dscv_impl", default="rows",
                   choices=["split", "rows", "rows_fused", "fused", "flat",
                            "expanded", "gather"], help=argparse.SUPPRESS)
    g.add_argument("--dscv_row_group", type=int, default=2,
                   help=argparse.SUPPRESS)
    g.add_argument("--dscv_x_window", type=int, default=5,
                   help=argparse.SUPPRESS)
    g.add_argument("--dscv_xw_dual", action=argparse.BooleanOptionalAction,
                   default=True, help=argparse.SUPPRESS)
    g.add_argument("--dscv_chunk_bytes", type=int, default=30 << 20,
                   help=argparse.SUPPRESS)
    g.add_argument("--remat_policy", default="dscv", choices=["dscv", "all"],
                   help="With --remat: recompute in the backward only the "
                        "DSCV (its autograd Function already saves only its "
                        "inputs, so this stores about as much as no remat) "
                        "or each whole decoder level (all)")
    g.add_argument("--dscv_bwd", default="xla",
                   choices=["xla", "corner", "pallas"],
                   help=argparse.SUPPRESS)
    g.add_argument("--sncv_impl", default="xla", choices=["xla", "pallas"],
                   help=argparse.SUPPRESS)
    g.add_argument("--time_axis", default="auto",
                   choices=["auto", "unroll", "scan"], help=argparse.SUPPRESS)
    g.add_argument("--scan_unroll", default=2, type=int,
                   help=argparse.SUPPRESS)
    g.add_argument("--remat", default=False, action="store_true",
                   help="Recompute decoder work in the backward pass instead "
                        "of storing it (torch.utils.checkpoint; trades device "
                        "time for memory, for long windows)")
    g.add_argument("--grad_clip_norm", default=0.0, type=float,
                   help="Global-norm gradient clip; 0 disables")
    g.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "staircase", "cosine"],
                   help="constant, the legacy halving at "
                        "60k/120k/180k/240k/300k steps, or warmup-cosine "
                        "decay over total_steps")
    g.add_argument("--seed", default=42, type=int,
                   help="Init/shuffle seed")
    g.add_argument("--data_mesh", default=-1, type=int,
                   help="Ranks on the data-parallel axis: -1 or the world "
                        "size that the launcher (torch.distributed.run) "
                        "set, 1 without one; --batch_size is each rank's")
    g.add_argument("--num_workers", default=8, type=int)
    g.add_argument("--learning_rate", default=1e-4, type=float)
    g.add_argument("--total_steps", default=220000, type=int)
    g.add_argument("--finetune_steps", default=20000, type=int)
    g.add_argument("--output_dir", default=None, type=str,
                   help="predict mode: write 16-bit depth PNGs here "
                        "(depth * 256, KITTI convention)")
    g.add_argument("--out_size", default=None, type=int, nargs=2,
                   metavar=("H", "W"),
                   help="Override the dataset's output size")
    g.add_argument("--validation_mode", default="sync",
                   choices=["sync", "subprocess"],
                   help="Run per-epoch validation inline (sync) or as a "
                        "background process")
    g.add_argument("--validation_device", default="",
                   choices=["", "cpu", "gpu"],
                   help="Platform of the validation subprocess (forwarded "
                        "as its --platform); empty: the trainer's own "
                        "--platform")
    g.add_argument("--validation_max_batches", default=0, type=int,
                   help="Bound the validation subset size (0 = full set)")
    return parser


def launcher_world() -> int:
    """The world size that a launcher (``torch.distributed.run``) set in
    ``WORLD_SIZE``; 1 without one."""
    return int(os.environ.get("WORLD_SIZE", 1))


def check_port_options(cmd, parser: argparse.ArgumentParser) -> None:
    """Print one line for each TPU-only or unused flag given a value other
    than ``parser``'s default, and raise ``ValueError`` for a
    ``--data_mesh`` other than -1 or the launcher's world size (the data
    axis spans every rank)."""
    for flags, why in ((TPU_ONLY, "the port has one implementation of this"),
                       (UNUSED, "the JAX CLI reads it nowhere either")):
        for flag in flags:
            if getattr(cmd, flag) != parser.get_default(flag):
                print(f"--{flag}={getattr(cmd, flag)}: {why}; the flag "
                      "changes nothing", flush=True)
    world = launcher_world()
    if cmd.data_mesh not in (-1, world):
        raise ValueError(
            f"--data_mesh={cmd.data_mesh}: the data axis spans every rank "
            f"and {world} were started (WORLD_SIZE); give -1 or {world}")


def device_from_args(cmd) -> torch.device:
    """``cpu`` with --platform=cpu, else the CUDA device (raises without
    one): under a launcher, the card of this rank's ``LOCAL_RANK``."""
    if cmd.platform == "cpu":
        return resolve_device("cpu")
    if "LOCAL_RANK" in os.environ:
        return resolve_device(torch.device(
            "cuda", int(os.environ["LOCAL_RANK"])))
    return resolve_device("cuda")


def ablation_from_args(cmd) -> AblationFlags:
    return AblationFlags(
        dinl=not cmd.no_DINL,
        sncv=not cmd.no_SNCV,
        time_recurr=not cmd.no_time_recurr,
        normalize_features=not cmd.no_feature_normalization,
        subdivide_features=not cmd.no_feature_subdivision,
        level_memory=not cmd.no_level_memory,
    )


def model_config_from_args(cmd, depth_type: str = "map") -> ModelConfig:
    return ModelConfig(
        num_levels=cmd.arch_depth,
        ablation=ablation_from_args(cmd),
        depth_type=depth_type,
        compute_dtype=cmd.compute_dtype,
        cv_dtype=cmd.cv_dtype,
        remat=cmd.remat,
        remat_policy=cmd.remat_policy,
    )


def train_config_from_args(cmd) -> TrainConfig:
    return TrainConfig(
        learning_rate=cmd.learning_rate,
        lr_schedule=cmd.lr_schedule,
        grad_clip_norm=cmd.grad_clip_norm,
        seed=cmd.seed,
        total_steps=cmd.total_steps,
        finetune_steps=cmd.finetune_steps,
        ckpt_dir=cmd.ckpt_dir,
        log_dir=cmd.log_dir,
        keep_top_n=cmd.keep_top_n,
        summary_interval=cmd.summary_interval,
        enable_validation=cmd.enable_validation,
    )


def dataset_locations(cmd) -> dict:
    if os.path.isfile(cmd.db_path_config):
        return load_dataset_locations(cmd.db_path_config)
    return {}


def finetune_total_steps(ckpt_dir: str, finetune_steps: int,
                         epoch_len: int) -> int:
    """Total optimizer steps of a (possibly resumed) finetune run: resume +
    steps // len + 1 epochs, so that a finetune shorter than an epoch
    still runs one."""
    from m4depth_tpu_torch.train.checkpoints import TrainCheckpointManager

    resume = TrainCheckpointManager(os.path.join(ckpt_dir, "train")
                                    ).resume_epoch
    return (resume + finetune_steps // epoch_len + 1) * epoch_len
