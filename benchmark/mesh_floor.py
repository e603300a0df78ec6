"""The least time one H100 could take for the row-mode work of one sharded
LPA superstep on each card, from the job's facts alone (not from the
program's padded plan), so that it reads the same work whatever
implements it.

A card must at least read, from HBM at 3.35 TB/s: 4 B for each message it
receives (the sender's id), 4 B twice for each vertex it owns (the row's
id and its result), and the full label vector once, 4 B a vertex. The
labels a message gathers are counted at 4 B, not at the 32-byte sectors a
gather from HBM moves, so the floor cannot be reached and reads low.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def card_floor_bytes(facts: dict) -> list:
    """Each card's floor in bytes, in card order, or [] without the facts."""
    messages = facts.get("card_messages")
    owned = facts.get("card_vertices")
    if not messages or not owned or "vertices" not in facts:
        return []
    return [4 * m + 8 * o + 4 * facts["vertices"] for m, o in zip(messages, owned)]


def card_floor_seconds(facts: dict) -> list:
    """Each card's floor in seconds a superstep, in card order."""
    return [b / HBM_BYTES_PER_S for b in card_floor_bytes(facts)]
