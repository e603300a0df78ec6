"""Pipeline configuration — one dataclass + CLI.

Counterpart of ``graphmine_tpu/pipeline/config.py`` for the fields the
single-device slice reads, plus ``device``: the same names, defaults and
validation.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass

from graphmine_tpu_torch.ops.lof import LOF_IMPLS


@dataclass
class PipelineConfig:
    # data: a parquet file, directory or glob of outlinks (string columns
    # _c1 -> _c2), or a whitespace edge list
    data_path: str = ""
    data_format: str = "parquet"  # parquet | edgelist
    batch_rows: int | None = None  # parquet only: stream in bounded batches
    # edgelist only: 0-based column holding a per-edge float weight
    # (weighted LPA: mode = argmax of incoming weight sums)
    edge_weight_col: int | None = None
    # community detection: exactly max_iter LPA supersteps
    max_iter: int = 5
    # outlier detection
    outlier_method: str = "both"  # recursive_lpa | lof | both | none
    sub_max_iter: int = 5
    decile: float = 0.1
    # LOF neighbourhood size; clamped to num_vertices - 1 on small graphs
    lof_k: int = 128
    # "auto" follows the JAX package's policy: the IVF index from 2^17
    # points (GRAPHMINE_LOF_IVF_MIN_N moves the crossover), the exact kNN
    # (the hand-written kernel on CUDA) below; "ivf" forces the index, and
    # "exact", "xla" and "pallas" (the JAX package's exact kernels) the
    # exact kNN.
    lof_impl: str = "auto"  # auto | xla | pallas | exact | ivf
    # exact clustering coefficient while the oriented wedge count stays
    # under this budget (~28 B of host scratch per wedge), else sampled
    wedge_budget: int = 250_000_000
    show: int = 10
    metrics_out: str | None = None  # JSON lines of every record
    # publish labels, CC labels, LOF, census and edges as a versioned
    # snapshot generation at this store directory, as the final phase
    snapshot_out: str | None = None
    device: str = "cuda"
    # count and set aside malformed rows and NaN weights at ingestion (a
    # "quarantine" record) instead of failing; --no-quarantine-inputs
    # parses strictly
    quarantine_inputs: bool = True

    def validate(self) -> "PipelineConfig":
        if self.data_format not in ("parquet", "edgelist"):
            raise ValueError(f"unknown data_format {self.data_format!r}")
        if self.outlier_method not in ("recursive_lpa", "lof", "both", "none"):
            raise ValueError(f"unknown outlier_method {self.outlier_method!r}")
        if self.lof_impl not in LOF_IMPLS:
            raise ValueError(f"unknown lof_impl {self.lof_impl!r}")
        if self.max_iter < 0 or self.sub_max_iter < 0:
            raise ValueError("max_iter must be >= 0")
        if self.batch_rows is not None and self.batch_rows <= 0:
            raise ValueError("batch_rows must be positive")
        if self.batch_rows is not None and self.data_format != "parquet":
            raise ValueError("batch_rows applies to parquet input only")
        if self.edge_weight_col is not None and self.data_format != "edgelist":
            raise ValueError("edge_weight_col applies to edgelist input only")
        if self.edge_weight_col is not None and self.edge_weight_col < 2:
            raise ValueError("edge_weight_col must be >= 2: columns 0-1 are the endpoints")
        if not 0 < self.decile < 1:
            raise ValueError("decile must be in (0, 1)")
        return self


def parse_args(argv=None) -> PipelineConfig:
    parser = argparse.ArgumentParser(
        prog="graphmine_tpu_torch.pipeline",
        description="Community + outlier detection pipeline on one CUDA device",
    )
    types = {"int": int, "float": float, "str": str, "str | None": str, "int | None": int}
    for f in dataclasses.fields(PipelineConfig):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool":
            parser.add_argument(name, action=argparse.BooleanOptionalAction, default=f.default)
        else:
            parser.add_argument(name, type=types[f.type], default=f.default)
    return PipelineConfig(**vars(parser.parse_args(argv))).validate()
