"""Pipeline configuration — one dataclass + CLI.

Counterpart of ``graphmine_tpu/pipeline/config.py`` for the fields the
single-device slice reads, plus ``device``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass
class PipelineConfig:
    # data (edge lists only; parquet: ROADMAP.md queue 1 item 2)
    data_path: str = ""
    data_format: str = "edgelist"
    # community detection: exactly max_iter LPA supersteps
    max_iter: int = 5
    # outlier detection
    outlier_method: str = "both"  # recursive_lpa | lof | both | none
    sub_max_iter: int = 5
    decile: float = 0.1
    # LOF neighbourhood size; clamped to num_vertices - 1 on small graphs
    lof_k: int = 128
    # "auto" follows the JAX package's policy, which picks the IVF index
    # from 2^17 points — not ported yet, so it raises there; "exact" runs
    # the exact kNN (the hand-written kernel on CUDA).
    lof_impl: str = "auto"  # auto | exact | ivf
    # exact clustering coefficient while the oriented wedge count stays
    # under this budget (~28 B of host scratch per wedge), else sampled
    wedge_budget: int = 250_000_000
    show: int = 10
    metrics_out: str | None = None  # JSON lines of every record
    device: str = "cuda"

    def validate(self) -> "PipelineConfig":
        if self.data_format == "parquet":
            raise NotImplementedError(
                "parquet input: ROADMAP.md queue 1 item 2; use --data-format edgelist"
            )
        if self.data_format != "edgelist":
            raise ValueError(f"unknown data_format {self.data_format!r}")
        if self.outlier_method not in ("recursive_lpa", "lof", "both", "none"):
            raise ValueError(f"unknown outlier_method {self.outlier_method!r}")
        if self.lof_impl not in ("auto", "exact", "ivf"):
            raise ValueError(f"unknown lof_impl {self.lof_impl!r}")
        if self.max_iter < 0 or self.sub_max_iter < 0:
            raise ValueError("max_iter must be >= 0")
        if not 0 < self.decile < 1:
            raise ValueError("decile must be in (0, 1)")
        return self


def parse_args(argv=None) -> PipelineConfig:
    parser = argparse.ArgumentParser(
        prog="graphmine_tpu_torch.pipeline",
        description="Community + outlier detection pipeline on one CUDA device",
    )
    types = {"int": int, "float": float, "str": str, "str | None": str}
    for f in dataclasses.fields(PipelineConfig):
        parser.add_argument("--" + f.name.replace("_", "-"), type=types[f.type],
                            default=f.default)
    return PipelineConfig(**vars(parser.parse_args(argv))).validate()
