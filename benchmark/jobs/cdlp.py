"""CDLP: ``max_iterations`` supersteps of label propagation through the
program's ``ops/lpa.py::label_propagation`` (plan ``"auto"``); the labels
are checked against the plain CDLP. The control stops one superstep
short."""

from __future__ import annotations

from benchmark.graphjob import GraphJob
from benchmark.reference.cdlp import cdlp


class Job(GraphJob):
    def __init__(self, *args):
        super().__init__(*args)
        self.max_iter = int(self.params["max_iterations"])
        self.facts["supersteps_per_job"] = self.max_iter

    def run(self):
        from graphmine_tpu_torch.ops import lpa

        return lpa.label_propagation(self.graph, max_iter=self.max_iter)

    def reference(self):
        return cdlp(*self.edges(), self.num_vertices, self.max_iter)

    def control(self):
        return cdlp(*self.edges(), self.num_vertices, self.max_iter - 1)
