"""LOF: exact-kNN Local Outlier Factor through the program's
``ops/lof.py::lof_scores(points, k, impl="exact")`` (the hand-written
``knn_topk`` kernel on the card, then ``lof_from_knn``), on the graph's
eight-column structural feature table.

The table is the benchmark's own: communities from the plain CDLP at the
configuration's iterations, the columns from their definitions
(``reference/features.py``), standardised. The scores are checked
against the plain LOF (neighbours on the configuration's float32
distances, scores in float64); the control takes the distances' cross
term in TF32.
"""

from __future__ import annotations

import torch

from benchmark.reference import features
from benchmark.reference.cdlp import cdlp
from benchmark.reference.lof import lof


class Job:
    def __init__(self, config: dict, traffic: dict, data: dict, device, seed: int):
        algos = config.get("algorithms", {})
        params = {**algos.get("lof", {}), **traffic.get("params", {})}
        self.k = int(params["k"])
        src, dst, v = data["src"], data["dst"], int(data["num_vertices"])
        communities = cdlp(src, dst, v, int(algos["cdlp"]["max_iterations"]))
        table = features.vertex_features(src, dst, v, communities,
                                         int(params["clustering_samples"]), seed)
        self.points = features.standardize(table)
        del table, communities
        self.facts = {"points": v, "features": int(self.points.shape[1]), "k": self.k,
                      "graph_edges": int(src.shape[0])}

    def setup(self, spans: dict) -> None:
        """The points are the program's input as they stand."""

    def run(self):
        from graphmine_tpu_torch.ops import lof as lof_ops

        return lof_ops.lof_scores(self.points, k=self.k, impl="exact")

    def release(self) -> None:
        """The program keeps no state between jobs."""

    def reference(self):
        return lof(self.points, self.k)

    def control(self):
        return lof(self.points, self.k, precision="tf32")

    @staticmethod
    def compare(output, reference) -> dict:
        """The widest gap of a score from the reference's, as a share of
        the reference's score."""
        gap = (output.to(torch.float64) - reference).abs() / reference.abs().clamp(min=1e-12)
        return {"lof_max_rel_gap": float(gap.max())}
