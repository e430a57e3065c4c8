"""The program under test, the port (shoulder_tpu_torch), imported in one
place: the loops call its entry points through these names, and the
harness reads its launch counters and loads the models the
configuration names through it."""

from __future__ import annotations

from pathlib import Path

import torch

from shoulder_tpu_torch import bone, cohort
from shoulder_tpu_torch.config import DEFAULT_CONFIG
from shoulder_tpu_torch.io import ingest
from shoulder_tpu_torch.models import ct_unet, forest, unet
from shoulder_tpu_torch.pipeline import batch as B
from shoulder_tpu_torch.pipeline import ct

from benchmark.harness import spec as S

__all__ = ["B", "bone", "cohort", "ct", "ingest", "DEFAULT_CONFIG"]


def config(conf: dict):
    """The port's PipelineConfig for a configuration file."""
    return S.pipeline_config(conf, DEFAULT_CONFIG)


def check_default_weights(conf: dict) -> None:
    """Entries that load their models themselves (the cohort, the facade,
    segment_volume) read the port's shipped files: raise unless those
    are the files the configuration names."""
    shipped = {"forest": forest.DEFAULT_NPZ, "unet": unet.DEFAULT_NPZ,
               "ct_unet": ct_unet.DEFAULT_NPZ}
    for name, path in conf["weights"].items():
        if Path(shipped[name]).resolve() != S.weight(conf, name).resolve():
            raise ValueError(f"{name}: the port serves {shipped[name]}, the "
                             f"configuration names {path}")


def models(conf: dict, cfg, device):
    """(forest, UNet or None) from the configuration's weight files."""
    check_default_weights(conf)
    rf = forest.load_params(device, S.weight(conf, "forest"))
    seg = (unet.load_model(device, S.weight(conf, "unet"))
           if cfg.segmenter == "unet" else None)
    return rf, seg


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launch_counters() -> int:
    """Launches of the port's own kernels so far (its wrappers' counters:
    the profiler does not count these as launch API calls)."""
    from shoulder_tpu_torch.utils import bench

    return bench.port_launches()
