"""WCC: weakly connected components to the fixpoint through the program's
``ops/cc.py::connected_components`` (plan ``"auto"``); the labels are
checked against the plain minimum-label propagation. The control stops
one superstep before the fixpoint."""

from __future__ import annotations

from benchmark.graphjob import GraphJob
from benchmark.reference.wcc import wcc


class Job(GraphJob):
    def run(self):
        from graphmine_tpu_torch.ops import cc

        labels, steps = cc.connected_components(self.graph, return_iterations=True)
        self.facts["supersteps_per_job"] = steps
        return labels

    def reference(self):
        return wcc(*self.edges(), self.num_vertices)[0]

    def control(self):
        edges = self.edges()
        _, steps = wcc(*edges, self.num_vertices)
        return wcc(*edges, self.num_vertices, max_steps=max(steps - 1, 0))[0]
