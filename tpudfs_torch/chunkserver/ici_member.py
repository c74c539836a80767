"""The member half of the collective write group's protocol — the port's own
copy of ``ChunkServer._try_ici_write`` (``tpudfs/chunkserver/service.py``,
lines 1209-1241).

A chunkserver serving a chain write asks its write group whether the chain
is the ring successor set of its position; if so the block rides a
collective round (``tpudfs_torch.gpu.write_group``) and the chunkserver
answers the WriteBlock with the round's replica count, else the caller runs
the TCP chain. The reference keeps this body in the chunkserver and names
the JAX package's exception class in it, so a chunkserver on a host without
JAX cannot run it; :meth:`IciWriteGroup.attach` binds :func:`try_ici_write`
on each member as its ``_try_ici_write``, and the reference chunkserver
(which calls ``self._try_ici_write``) serves collective writes through it.

The member is duck-typed: ``address``, ``ici_fallbacks`` (an int),
``invalidate_cached(block_id)``, ``async persist_ici_replica(...)`` (the
fenced persist the group calls), and the ``_ici_group`` / ``_ici_pos``
that ``attach`` sets.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


async def try_ici_write(cs, block_id: str, data: bytes, req: dict,
                        next_servers: list[str]) -> dict | None:
    """Stage this chain write into ``cs``'s collective group when the chain
    IS the member's ring successor set. Returns the WriteBlock response, or
    None to fall back to the TCP chain (counted in ``cs.ici_fallbacks``)."""
    group = cs._ici_group
    if len(next_servers) + 1 != group.replication:
        # Not a candidate at all (an intermediate TCP hop's shorter chain,
        # or a short allocation): no fallback counted — the gauge tracks
        # writes that COULD have ridden a round but didn't.
        return None
    if not group.healthy() \
            or next_servers != group.successors(cs._ici_pos):
        cs.ici_fallbacks += 1
        return None
    try:
        written = await group.submit(
            cs._ici_pos, block_id, data,
            int(req.get("master_term", 0)),
            str(req.get("master_shard") or ""),
        )
    except group.Error as e:
        logger.warning("collective write of %s fell back to TCP chain: %s",
                       block_id, e)
        cs.ici_fallbacks += 1
        return None
    cs.invalidate_cached(block_id)
    return {"success": True, "error_message": "",
            "replicas_written": written}
