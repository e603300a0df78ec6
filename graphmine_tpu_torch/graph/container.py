"""Device-resident graph container (PyTorch).

Counterpart of ``graphmine_tpu/graph/container.py``. A graph is a set of
dense int32 index tensors on one device. Every superstep consumes the
*message CSR*: the 2E-long (receiver, sender) pair sorted by receiver.
Messages flow along both directions of every directed edge and duplicate
edges are kept with multiplicity, exactly as in the JAX package, so the
CSR arrays of the two packages are array-equal. A weighted graph carries
each edge's weight on both of its messages (``msg_weight``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graphmine_tpu_torch.device import resolve_device

# Kernels index the [M] message arrays with int32; a larger message count
# would wrap.
_INT32_MAX = (1 << 31) - 1


@dataclass(frozen=True)
class Graph:
    """Static-shape graph: edges + message CSR, all int32 on one device.

    ``src, dst`` [E] directed edge endpoints; ``msg_recv`` [M] receiver of
    each message, ascending; ``msg_send`` [M] its sender; ``msg_ptr``
    [V+1] CSR row pointers; ``symmetric``: messages flow both directions;
    ``msg_weight`` [M] float32 weight of each message (its edge's), or
    ``None`` on an unweighted graph.
    """

    src: torch.Tensor
    dst: torch.Tensor
    msg_recv: torch.Tensor
    msg_send: torch.Tensor
    msg_ptr: torch.Tensor
    num_vertices: int
    symmetric: bool = True
    msg_weight: torch.Tensor | None = None

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_messages(self) -> int:
        return int(self.msg_recv.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def degrees(self) -> torch.Tensor:
        """Message-degree per vertex (undirected degree with multiplicity
        when ``symmetric``), the segment sizes of the message CSR."""
        return self.msg_ptr[1:] - self.msg_ptr[:-1]


def _prepare_edges(src, dst, num_vertices):
    """Shared endpoint coercion/validation/V-inference for graph builders."""
    # contiguous: a reversed or strided view cannot back a tensor
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src/dst must be equal-length 1-D arrays")
    if num_vertices is None:
        num_vertices = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    if len(src) and (
        min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= num_vertices
    ):
        raise ValueError(f"edge endpoint out of range [0, {num_vertices})")
    return src, dst, num_vertices


def _prepare_weights(edge_weights, src: np.ndarray):
    """Edge weights as float32 ``[E]``, one per edge, each >= 0 and not
    NaN; ``None`` stays ``None``."""
    if edge_weights is None:
        return None
    w = np.ascontiguousarray(edge_weights, dtype=np.float32)
    if w.shape != src.shape:
        raise ValueError("edge_weights must be one float per edge")
    if len(w) and not np.all(w >= 0):  # NaN >= 0 is False
        raise ValueError("edge_weights must be non-negative and not NaN")
    return w


def message_ptr(src, dst, num_vertices: int, symmetric: bool = True,
                recv=None) -> np.ndarray:
    """CSR row pointers of the message layout (host int64 ``[V+1]``): the
    receivers are ``concat(dst, src)`` when ``symmetric`` (both directions,
    duplicates kept), else ``dst``, grouped by receiver. ``recv`` is that
    concatenation when the caller already has it. The JAX package's
    layout contract, on host arrays or tensors of any device."""
    if recv is None:
        src, dst = _host(src), _host(dst)
        recv = np.concatenate([dst, src]) if symmetric else dst
    counts = np.bincount(_host(recv), minlength=num_vertices)
    ptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    if ptr[-1] >= np.iinfo(np.int32).max:
        raise ValueError("message count exceeds int32; shard the build")
    return ptr


def _host(values) -> np.ndarray:
    return values.cpu().numpy() if isinstance(values, torch.Tensor) else np.asarray(values)


def _message_csr(src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
                 symmetric: bool, weights: torch.Tensor | None = None):
    """``(ptr int64 [V+1], recv_sorted, send_sorted int32 [M], w_sorted
    float32 [M] | None)``: messages grouped by receiver in stable order,
    built on ``src``'s device. A stable sort keeps the senders of one
    receiver in message order, the order NumPy's stable argsort and the
    JAX package's native counting sort produce; both messages of an edge
    carry its weight through the same permutation."""
    if symmetric:
        recv = torch.cat([dst, src])
        send = torch.cat([src, dst])
        w = None if weights is None else torch.cat([weights, weights])
    else:
        recv, send, w = dst, src, weights
    ptr = torch.zeros(num_vertices + 1, dtype=torch.int64, device=src.device)
    ptr[1:] = torch.cumsum(torch.bincount(recv, minlength=num_vertices), 0)
    if int(ptr[-1]) > _INT32_MAX:
        raise ValueError(
            f"message count {int(ptr[-1]):,} exceeds the int32 index bound "
            f"{_INT32_MAX:,} for a single device"
        )
    order = torch.argsort(recv, stable=True)
    return ptr, recv[order], send[order], None if w is None else w[order]


def build_graph(src, dst, num_vertices: int | None = None, symmetric: bool = True,
                edge_weights=None, device=None) -> Graph:
    """Build a :class:`Graph` from host endpoint arrays on ``device``
    (CUDA unless the caller asks for another device); ``edge_weights``
    (one float >= 0 per edge) makes it weighted."""
    graph, _ = _build_with_csr(src, dst, num_vertices, symmetric, edge_weights, device)
    return graph


def _build_with_csr(src, dst, num_vertices, symmetric, edge_weights, device):
    """``(Graph, host int64 ptr)``: the shared body of the graph builders."""
    dev = resolve_device(device)
    src, dst, num_vertices = _prepare_edges(src, dst, num_vertices)
    w = _prepare_weights(edge_weights, src)
    src_t = torch.from_numpy(src).to(dev)
    dst_t = torch.from_numpy(dst).to(dev)
    w_t = None if w is None else torch.from_numpy(w).to(dev)
    ptr, recv, send, w_sorted = _message_csr(src_t, dst_t, num_vertices, symmetric, w_t)
    graph = Graph(
        src=src_t, dst=dst_t, msg_recv=recv, msg_send=send,
        msg_ptr=ptr.to(torch.int32), num_vertices=num_vertices, symmetric=symmetric,
        msg_weight=w_sorted,
    )
    return graph, ptr.cpu().numpy()


def graph_from_edge_table(table, symmetric: bool = True, device=None) -> Graph:
    """Build a graph from an :class:`~graphmine_tpu_torch.io.edges.EdgeTable`;
    its weights, if any, make the graph weighted."""
    return build_graph(table.src, table.dst, num_vertices=table.num_vertices,
                       symmetric=symmetric, edge_weights=table.weights, device=device)


def simple_undirected_edges(graph: Graph) -> tuple[np.ndarray, np.ndarray]:
    """Host-side simplification: distinct undirected edges, no self-loops.

    Returns ``(a, b)`` int32 arrays with ``a < b``, one row per undirected
    edge, in ascending ``(a, b)`` order.
    """
    src = graph.src.cpu().numpy()
    dst = graph.dst.cpu().numpy()
    v = graph.num_vertices
    keep = src != dst
    a = np.minimum(src[keep], dst[keep]).astype(np.int64)
    b = np.maximum(src[keep], dst[keep]).astype(np.int64)
    und = np.unique(a * v + b)
    return (und // v).astype(np.int32), (und % v).astype(np.int32)
