"""What the graph jobs share: the generated edges kept on the host, handed
to the program's ``build_graph`` in set-up, and moved back to the device
for the reference once the program's graph is gone."""

from __future__ import annotations

import torch

from benchmark.harness import span, synchronizer


class GraphJob:
    """Base of a job over one graph: ``self.graph`` is the program's
    :class:`Graph` after :meth:`setup`."""

    def __init__(self, config: dict, traffic: dict, data: dict, device, seed: int):
        self.device = device
        self.seed = int(seed)
        self.params = {**config.get("algorithms", {}).get(traffic["job"], {}),
                       **traffic.get("params", {})}
        self.src = data["src"].cpu().numpy()
        self.dst = data["dst"].cpu().numpy()
        self.num_vertices = int(data["num_vertices"])
        self.graph = None
        self.facts = {"vertices": self.num_vertices, "edges": int(self.src.shape[0]),
                      "messages": 2 * int(self.src.shape[0])}

    def setup(self, spans: dict) -> None:
        from graphmine_tpu_torch.graph import container

        with span(spans, "build_graph_s", synchronizer(self.device)):
            self.graph = container.build_graph(self.src, self.dst,
                                               num_vertices=self.num_vertices,
                                               device=self.device)

    def release(self) -> None:
        self.graph = None

    def edges(self) -> tuple:
        """The generated edges on the device, for the reference."""
        return (torch.from_numpy(self.src).to(self.device),
                torch.from_numpy(self.dst).to(self.device))

    @staticmethod
    def compare(output, reference) -> dict:
        """Vertices whose label differs from the reference's."""
        return {"label_mismatches": int((output.to(torch.int64) != reference).sum())}
