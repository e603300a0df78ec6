"""Pipeline configuration — one dataclass + CLI.

Counterpart of ``graphmine_tpu/pipeline/config.py``, plus ``device``: the
same names, defaults, validation and flags, the resilience knobs flattened
onto the CLI (``--max-retries``, ``--superstep-timeout-s``,
``--tripwire-every-k``, ...). ``community_method`` and ``gamma`` choose
LPA, Louvain or Leiden (``--community-method``, ``--gamma``). ``backend``
takes the JAX package's names: ``"jax"`` (the default) is this package's
own engine, ``"graphframes"`` hands LPA to a pyspark + GraphFrames install
(``pipeline/backends.py``). ``num_devices`` and ``schedule``
(``--num-devices``, ``--schedule``) run LPA on a mesh of that many of the
visible devices (:func:`graphmine_tpu_torch.device.visible_devices`).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field

from graphmine_tpu_torch.ops.lof import LOF_IMPLS
from graphmine_tpu_torch.pipeline.resilience import ResilienceConfig


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
    # community detection: lpa (exactly max_iter supersteps) | louvain |
    # leiden (their modularity resolution is gamma)
    community_method: str = "lpa"
    # engine: "jax" (the JAX package's name for the native engine: here
    # the port's own) | "graphframes" (LPA through pyspark + GraphFrames)
    backend: str = "jax"
    # devices of the mesh; None = every visible one (the distinct CUDA
    # cards, or the GRAPHMINE_VIRTUAL_DEVICES shards of one device)
    num_devices: int | None = None
    # the multi-device LPA schedule: "auto" lets the memory planner pick
    # (one device: the single-device superstep; else "replicated", the
    # full label vector on every shard, before "ring", labels sharded);
    # an explicit one is honoured but still checked at plan time
    schedule: str = "auto"  # auto | replicated | ring
    max_iter: int = 5
    gamma: float = 1.0
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
    # torch.profiler trace of the LPA phase (a Chrome trace in this dir)
    profile_dir: str | None = None
    # every record as JSON lines, appended as emitted (a resumed run adds
    # a run_start-delimited segment)
    metrics_out: str | None = None
    # run identity stamped on every record; None generates a sortable UTC id
    run_id: str | None = None
    # a heartbeat record every N seconds (phase, gauges, RSS); None = off
    heartbeat_every_s: float | None = None
    # the counter/gauge registry as a Prometheus textfile, written
    # atomically at each heartbeat and at exit
    prom_out: str | None = None
    # publish labels, CC labels, LOF, census and edges as a versioned
    # snapshot generation at this store directory, as the final phase
    snapshot_out: str | None = None
    # LPA label checkpoints: every checkpoint_every supersteps and always
    # the last, in the JAX package's npz format; --resume continues from
    # the newest one that matches the graph's fingerprint
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = False
    # retry/backoff budget, superstep watchdog, degradation policy and
    # divergence tripwires (flattened onto the CLI)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    device: str = "cuda"
    # count and set aside malformed rows and NaN weights at ingestion (a
    # "quarantine" record) instead of failing; --no-quarantine-inputs
    # parses strictly
    quarantine_inputs: bool = True

    def validate(self) -> "PipelineConfig":
        self.resilience.validate()
        if self.data_format not in ("parquet", "edgelist"):
            raise ValueError(f"unknown data_format {self.data_format!r}")
        if self.outlier_method not in ("recursive_lpa", "lof", "both", "none"):
            raise ValueError(f"unknown outlier_method {self.outlier_method!r}")
        if self.lof_impl not in LOF_IMPLS:
            raise ValueError(f"unknown lof_impl {self.lof_impl!r}")
        if self.community_method not in ("lpa", "louvain", "leiden"):
            raise ValueError(f"unknown community_method {self.community_method!r}")
        if self.backend not in ("jax", "graphframes"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.schedule not in ("auto", "replicated", "ring"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.backend == "graphframes" and self.community_method != "lpa":
            raise ValueError(
                "backend='graphframes' only provides labelPropagation; "
                "use community_method='lpa' or backend='jax'"
            )
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
        if self.edge_weight_col is not None and self.backend == "graphframes":
            raise ValueError(
                "backend='graphframes' runs unweighted labelPropagation; "
                "use backend='jax' for weighted LPA"
            )
        if not 0 < self.decile < 1:
            raise ValueError("decile must be in (0, 1)")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if self.heartbeat_every_s is not None and self.heartbeat_every_s <= 0:
            raise ValueError("heartbeat_every_s must be positive (or unset)")
        return self


def parse_args(argv=None) -> PipelineConfig:
    parser = argparse.ArgumentParser(
        prog="graphmine_tpu_torch.pipeline",
        description="Community + outlier detection pipeline on CUDA devices",
    )
    types = {"int": int, "float": float, "str": str, "str | None": str, "int | None": int,
             "float | None": float}

    def add_field(f):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool":
            parser.add_argument(name, action=argparse.BooleanOptionalAction, default=f.default)
        else:
            parser.add_argument(name, type=types[f.type], default=f.default)

    for f in dataclasses.fields(PipelineConfig):
        if f.name != "resilience":  # nested: its fields flatten onto the CLI
            add_field(f)
    res_fields = dataclasses.fields(ResilienceConfig)
    for f in res_fields:
        add_field(f)
    ns = vars(parser.parse_args(argv))
    resilience = ResilienceConfig(**{f.name: ns.pop(f.name) for f in res_fields})
    return PipelineConfig(**ns, resilience=resilience).validate()
