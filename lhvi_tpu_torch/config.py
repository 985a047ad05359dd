"""Experiment configs of the port (a copy of ``lhvi_tpu/config.py``, which
cannot be imported here: importing ``lhvi_tpu`` pulls in JAX).

Each BASELINE.json acceptance config is a dataclass with CLI binding via
``add_args``/``from_args``; the fields, defaults and flag spellings are the
reference's, so one command line configures either package. Framework-free.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class EngineConfig:
    engine: str = "nuts"  # nuts|hmc|vi|smc|lbp|epbp|gabp|mws
    n_chains: int = 32
    n_warmup: int = 500
    n_samples: int = 1000
    vi_k: int = 4
    vi_iters: int = 2000
    vi_lr: float = 5e-2
    smc_particles: int = 4096
    smc_temps: int = 50
    # CESS-targeted adaptive tempering + deadband step adaptation
    # (smc_temps becomes the static cap; see engines/smc.py SMCConfig)
    smc_adaptive: bool = False
    bp_iters: int = 30
    particles: int = 128
    seed: int = 0
    lifted: bool = False
    collect: str = "samples"  # samples|moments
    metrics_path: Optional[str] = None
    checkpoint_dir: Optional[str] = None


@dataclass
class ChainConfig(EngineConfig):
    """BASELINE config 1: 3-variable hybrid Gaussian–discrete chain."""


@dataclass
class GridConfig(EngineConfig):
    """BASELINE config 2: grid Gaussian MRF with evidence nodes."""

    rows: int = 10
    cols: int = 10
    evidence_frac: float = 0.2


@dataclass
class FriendsSmokersConfig(EngineConfig):
    """BASELINE config 3: relational hybrid MLN with lifted compression.

    Defaults to VI: parameter tying on the lifted IR is exact for VI/BP,
    whereas sampling engines on a lifted IR target the orbit-collapsed
    model (use ``--lifted false`` for grounded sampling)."""

    engine: str = "vi"
    n_people: int = 50
    hybrid: bool = True
    lifted: bool = True


@dataclass
class LDSConfig(EngineConfig):
    """BASELINE config 4: Kalman-like LDS under SMC.

    Production default is ADAPTIVE tempering (VERDICT r4 #3: measured
    strictly tighter at equal moves, and the fixed grid silently loses
    rejuvenation acceptance on stiff targets); ``--smc-adaptive false``
    restores the fixed β grid (the identity tests pin that path)."""

    T: int = 20
    engine: str = "smc"
    smc_adaptive: bool = True


@dataclass
class RobotMapConfig(EngineConfig):
    """Robot-mapping HMLN: hybrid relational model + on-disk evidence
    (reference robot-mapping experiment family, SURVEY.md §3.1)."""

    engine: str = "vi"
    n_segments: int = 24
    data: str = ""  # evidence file; default examples/data/robot_map.db
    n_chains: int = 64
    vi_iters: int = 3000


@dataclass
class PodConfig(EngineConfig):
    """BASELINE config 5: ~1e5 grounded variables, sharded chains."""

    n_people: int = 320
    evidence_people: int = 16
    # per-rank chain count; scale total chains with the ranks of the
    # process group (parallel.chain_sharding). 128 is the reference's
    # default, sized on a TPU (docs/PERF.md "environment limits"), not on
    # the port's card.
    n_chains: int = 128
    collect: str = "moments"


def add_args(parser: argparse.ArgumentParser, cfg) -> None:
    """Register every dataclass field as a --flag with its default."""
    for f in dataclasses.fields(cfg):
        default = getattr(cfg, f.name)
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(default, bool):
            parser.add_argument(
                name, type=lambda s: s.lower() in ("1", "true", "yes"),
                default=default,
            )
        else:
            typ = type(default) if default is not None else str
            parser.add_argument(name, type=typ, default=default)


def from_args(cls, args: argparse.Namespace):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in names})
