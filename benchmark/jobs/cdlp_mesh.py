"""CDLP on the cell's cards in one process: ``max_iterations`` supersteps of
the program's sharded LPA (``parallel/sharded.py::sharded_label_propagation``)
on the in-process mesh over ``job.devices`` (``parallel/mesh.py::make_mesh``,
one vertex range a card), partitioned on the cards by
``partition_graph_on_mesh``, as the pipeline's replicated schedule does on
CUDA cards. The labels are checked against the plain CDLP computed over
blocks of receivers spread on the cards; the control stops one superstep
short."""

from __future__ import annotations

import torch

from benchmark.graphjob import GraphJob
from benchmark.harness import span, synchronizer
from benchmark.reference.cdlp_blocked import cdlp_blocked

# Messages a block of the reference holds at most: its int64 keys and
# their sort stay a few GB on a card.
REFERENCE_BLOCK_MESSAGES = 1 << 27


class Job(GraphJob):
    def __init__(self, config, traffic, data, device, seed):
        super().__init__(config, traffic, data, device, seed)
        # the configuration's CDLP entry (the job's own name differs)
        cdlp = {**config["algorithms"]["cdlp"], **self.params}
        self.max_iter = int(cdlp["max_iterations"])
        self.facts["supersteps_per_job"] = self.max_iter
        self.devices = [self.device]
        self.mesh = None
        self.sg = None

    def setup(self, spans: dict) -> None:
        from graphmine_tpu_torch.parallel.mesh import make_mesh
        from graphmine_tpu_torch.parallel.sharded import partition_graph_on_mesh

        self._card_facts()
        self.mesh = make_mesh(len(self.devices), devices=self.devices)
        with span(spans, "mesh_partition_s", synchronizer(self.devices)):
            self.sg = partition_graph_on_mesh(self.src, self.dst, self.num_vertices, self.mesh,
                                              lpa_only=True)

    def _card_facts(self) -> None:
        """The cards, and each card's received messages and owned vertices
        under the configuration's split (one vertex range a card, as
        ``partition_graph`` makes them), counted from the edges."""
        d, v = len(self.devices), self.num_vertices
        vc = -(-(-(-v // d)) // 8) * 8
        src, dst = self.edges()
        received = (torch.bincount(torch.div(src, vc, rounding_mode="floor"), minlength=d)
                    + torch.bincount(torch.div(dst, vc, rounding_mode="floor"), minlength=d))
        del src, dst
        self.facts["cards"] = d
        self.facts["card_messages"] = [int(x) for x in received.tolist()]
        self.facts["card_vertices"] = [max(min(vc, v - s * vc), 0) for s in range(d)]

    def run(self):
        from graphmine_tpu_torch.parallel.sharded import sharded_label_propagation

        return sharded_label_propagation(self.sg, self.mesh, max_iter=self.max_iter)

    def release(self) -> None:
        self.sg = None
        self.mesh = None

    def _reference(self, supersteps: int):
        src, dst = self.edges()
        blocks = max(1, -(-2 * int(src.shape[0]) // REFERENCE_BLOCK_MESSAGES))
        return cdlp_blocked(src, dst, self.num_vertices, supersteps, blocks=blocks,
                            devices=self.devices)

    def reference(self):
        return self._reference(self.max_iter)

    def control(self):
        return self._reference(self.max_iter - 1)
