"""Checkpoint namespace layout: the port's own copy of
``tpudfs/common/ckptpaths.py`` (pure string code, name for name the same
paths and parses), so that ``tpudfs_torch.gpu.checkpoint`` writes and lists
exactly where the reference manager, the master's incomplete-checkpoint GC
and the chaos harness look. The safety argument of the two-phase commit is
a property of this layout:

- ``{base}/MANIFEST-{step:016d}`` — a PUBLISHED checkpoint. Created only by
  the atomic ``publish_checkpoint`` master command (a rename of the staged
  manifest), so readers that list ``{base}/MANIFEST-`` see each step either
  fully published or not at all — never a blend.
- ``{base}/.ckpt/{step:016d}/…`` — the per-step staging prefix: shard
  payloads (``shard-NNNNN.bin`` hot 3x-replicated copy, ``shard-NNNNN.ec``
  EC cold copy), per-shard specs (``shard-NNNNN.json``) and the staged
  ``MANIFEST``. Everything under it is invisible garbage until the step's
  manifest publishes; after publishing it is the checkpoint's data and is
  only removed by an explicit prune (manifest deleted FIRST).

The zero-padded 16-digit step makes lexicographic listing order equal
numeric step order, so "latest checkpoint" is one prefix listing plus a max.
"""

from __future__ import annotations

MANIFEST_PREFIX = "MANIFEST-"
#: Staging directory component. The leading dot keeps staging traffic out of
#: casual prefix listings of ``base`` and gives the master GC an unambiguous
#: infix to recognize staging files by.
STEP_DIR = ".ckpt"
_STEP_WIDTH = 16


def _norm(base: str) -> str:
    return base.rstrip("/")


def manifest_path(base: str, step: int) -> str:
    """The published manifest name for ``step``."""
    return f"{_norm(base)}/{MANIFEST_PREFIX}{step:0{_STEP_WIDTH}d}"


def manifest_list_prefix(base: str) -> str:
    """Listing this prefix yields exactly the published checkpoints."""
    return f"{_norm(base)}/{MANIFEST_PREFIX}"


def step_prefix(base: str, step: int) -> str:
    """Staging prefix for ``step`` (trailing slash included)."""
    return f"{_norm(base)}/{STEP_DIR}/{step:0{_STEP_WIDTH}d}/"


def staging_root(base: str) -> str:
    """Prefix covering every step's staging directory under ``base``."""
    return f"{_norm(base)}/{STEP_DIR}/"


def staged_manifest_path(base: str, step: int) -> str:
    return step_prefix(base, step) + "MANIFEST"


def shard_data_path(base: str, step: int, shard: int) -> str:
    """Hot (replicated) shard payload."""
    return step_prefix(base, step) + f"shard-{shard:05d}.bin"


def shard_ec_path(base: str, step: int, shard: int) -> str:
    """Erasure-coded cold copy of the same payload bytes."""
    return step_prefix(base, step) + f"shard-{shard:05d}.ec"


def shard_spec_path(base: str, step: int, shard: int) -> str:
    """Per-shard spec (tensor layout + CRCs) written by the replica that
    owns the shard; the commit coordinator aggregates these into the
    manifest without ever seeing the tensors."""
    return step_prefix(base, step) + f"shard-{shard:05d}.json"


def parse_manifest_path(path: str) -> tuple[str, int] | None:
    """``(base, step)`` when ``path`` is a published manifest, else None."""
    head, _, tail = path.rpartition("/")
    if not head or not tail.startswith(MANIFEST_PREFIX):
        return None
    digits = tail[len(MANIFEST_PREFIX):]
    if len(digits) != _STEP_WIDTH or not digits.isdigit():
        return None
    return head, int(digits)


def parse_step_path(path: str) -> tuple[str, int] | None:
    """``(base, step)`` when ``path`` lies under some step's staging
    prefix, else None. Recognizes the layout by the ``/.ckpt/`` infix plus
    a well-formed step component — the master GC uses this to tell
    checkpoint staging files from ordinary user files."""
    marker = f"/{STEP_DIR}/"
    idx = path.find(marker)
    if idx <= 0:
        return None
    rest = path[idx + len(marker):]
    digits, _, remainder = rest.partition("/")
    if len(digits) != _STEP_WIDTH or not digits.isdigit() or not remainder:
        return None
    return path[:idx], int(digits)
