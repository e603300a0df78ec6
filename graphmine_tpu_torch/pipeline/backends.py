"""Backend plugin boundary: jax (native) | graphframes (legacy).

The port's own copy of ``graphmine_tpu/pipeline/backends.py`` (the JAX
package's backend names: ``"jax"`` is the native engine, here the
port's). The original Spark driver stays a plugin boundary: the pipeline
dispatches community detection to the native engine or to GraphFrames. The graphframes path needs a
pyspark+JVM+graphframes environment (the reference's ``README.md:1-22``
setup); it is gated, not bundled.
"""

from __future__ import annotations

import numpy as np


class GraphFramesUnavailable(RuntimeError):
    pass


# The bridge materializes per-row Python lists on the driver, exactly the
# scaling cliff the reference hits (Graphframes.py:100-118). It exists for
# small-graph cross-validation only; refuse anything bigger.
MAX_BRIDGE_EDGES = 5_000_000


def lpa_graphframes(edge_table, max_iter: int) -> np.ndarray:
    """Run labelPropagation via GraphFrames (reference engine, Graphframes.py:78-81).

    Returns int labels aligned to the edge table's dense vertex ids.
    Raises :class:`GraphFramesUnavailable` when pyspark/graphframes are not
    installed (they are not part of this environment), and ``ValueError``
    beyond :data:`MAX_BRIDGE_EDGES` — the driver-side row lists below
    would OOM like the reference does; the native backend is the scale path.
    """
    if edge_table.num_edges > MAX_BRIDGE_EDGES:
        raise ValueError(
            f"graphframes bridge is capped at {MAX_BRIDGE_EDGES:,} edges "
            f"(got {edge_table.num_edges:,}): it collects driver-side row "
            "lists; use backend='jax' at scale"
        )
    try:
        import pyspark  # noqa: F401
        from graphframes import GraphFrame  # noqa: F401
    except ImportError as e:
        raise GraphFramesUnavailable(
            "backend='graphframes' needs pyspark + graphframes "
            "(see the reference README: spark-2.4.5 + graphframes 0.6.0); "
            "install them or use backend='jax'"
        ) from e

    from pyspark.sql import SparkSession

    spark = SparkSession.builder.appName("CommunityDetection").getOrCreate()
    try:
        v_rows = [(int(i), str(n)) for i, n in enumerate(edge_table.names)]
        e_rows = [(int(s), int(d)) for s, d in zip(edge_table.src, edge_table.dst)]
        vertices = spark.createDataFrame(v_rows, ["id", "name"])
        edges = spark.createDataFrame(e_rows, ["src", "dst"])
        result = GraphFrame(vertices, edges).labelPropagation(maxIter=max_iter)
        rows = result.select("id", "label").collect()
    finally:
        spark.stop()
    labels = np.zeros(edge_table.num_vertices, dtype=np.int64)
    for r in rows:
        labels[r["id"]] = r["label"]
    return labels
