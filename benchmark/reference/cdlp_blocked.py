"""Community detection by label propagation (LDBC Graphalytics CDLP), the
semantics of ``reference/cdlp.py`` computed over blocks of receivers, so
that a graph whose messages do not fit one ``torch.unique`` fits a card.

Every vertex starts with its own id as label. In each of ``max_iter``
synchronous supersteps every vertex takes the label that is most frequent
among its neighbours, ties to the smallest label; a vertex with no
neighbour keeps its label. Each edge sends its label both ways, and an
edge that is listed twice counts twice. A block is a range of receivers
with every message they receive: its counts, and so its labels, are those
of the whole graph's. The blocks may live on several devices; the label
vector is copied to each device once a superstep. Integers only.
"""

from __future__ import annotations

import torch


def _block_messages(src, dst, lo: int, hi: int, device) -> tuple:
    """``(receiver - lo, sender)`` int64 of the messages received in
    ``[lo, hi)``, on ``device``."""
    recv, send = [], []
    for r, s in ((dst, src), (src, dst)):
        at = torch.nonzero((r >= lo) & (r < hi)).squeeze(1)
        recv.append(r[at].to(device))
        send.append(s[at].to(device))
    return (torch.cat(recv).to(torch.int64) - lo, torch.cat(send).to(torch.int64))


def cdlp_blocked(src: torch.Tensor, dst: torch.Tensor, num_vertices: int, max_iter: int,
                 blocks: int = 1, devices=None) -> torch.Tensor:
    """int64 labels ``[V]`` after ``max_iter`` supersteps, on the edges'
    device; the receivers split into ``blocks`` ranges, block ``b`` on
    ``devices[b % len(devices)]`` (default: the edges' device)."""
    v = int(num_vertices)
    home = src.device
    devices = list(devices) if devices else [home]
    cuts = [v * b // blocks for b in range(blocks + 1)]
    parts = []
    for b in range(blocks):
        lo, hi = cuts[b], cuts[b + 1]
        dev = devices[b % len(devices)]
        parts.append((lo, hi, dev, *_block_messages(src, dst, lo, hi, dev)))
    labels = torch.arange(v, dtype=torch.int64, device=home)
    for _ in range(max_iter):
        copies = {dev: labels.to(dev) for dev in devices}
        new = []
        for lo, hi, dev, recv, send in parts:
            lab_all = copies[dev]
            n = hi - lo
            # one row per distinct (receiver, label) pair, with its count
            pairs, counts = torch.unique(recv * v + lab_all[send], return_counts=True)
            r, lab = pairs // v, pairs % v
            del pairs
            best = torch.zeros(n, dtype=counts.dtype, device=dev).scatter_reduce_(
                0, r, counts, "amax")
            top = counts == best[r]
            pick = torch.full((n,), v, dtype=torch.int64, device=dev).scatter_reduce_(
                0, r[top], lab[top], "amin")
            new.append(torch.where(pick < v, pick, lab_all[lo:hi]).to(home))
        labels = torch.cat(new) if new else labels
    return labels
