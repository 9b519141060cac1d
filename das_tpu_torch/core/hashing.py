"""Content-addressed atom identity.

Every atom (typed node or variable-arity link) is identified by an md5 hex
digest, byte-for-byte compatible with the reference hasher
(reference das/expression_hasher.py:4-35):

  * ``named_type_hash(t)   = md5(t)``
  * ``terminal_hash(t, n)  = md5(t + " " + n)``
  * ``expression_hash(th, targets) = composite_hash([th, *targets])``
  * ``composite_hash([x])  = x``  (singleton collapse)
  * ``composite_hash(xs)   = md5(" ".join(xs))``

TPU-first design: hex strings never reach the device.  Each 128-bit digest is
truncated to a signed int64 (first 8 bytes, big-endian) which is the *device
handle* used in every HBM-resident table.  The full hex digest survives only
in host-side dictionaries at the API boundary, so result sets can be reported
with reference-identical handles.  At 2^64 key space, the collision
probability for a 10^9-atom KB is ~2.7e-2 ppm (birthday bound) — and the
host-side hex map detects any collision at ingest time.
"""

from __future__ import annotations

from hashlib import md5
from typing import Iterable, List, Sequence, Union

import numpy as np

COMPOUND_SEPARATOR = " "

# Signed-int64 device handle for the wildcard '*' sentinel is never needed:
# wildcards are compile-time structure, not data.  Still, reserve a sentinel
# for "empty slot" in device hash tables / padded target columns.
EMPTY_I64 = np.int64(-(2**63))  # never produced by digest truncation (see below)
I64_PAD_MAX = 2**63 - 1  # capacity-pad sentinel; also excluded from key range


def compute_hash(text: str) -> str:
    """md5 hex digest of utf-8 text (reference `_compute_hash`)."""
    return md5(text.encode("utf-8")).hexdigest()


def named_type_hash(name: str) -> str:
    return compute_hash(name)


def terminal_hash(named_type: str, terminal_name: str) -> str:
    return compute_hash(named_type + COMPOUND_SEPARATOR + terminal_name)


def composite_hash(hash_base: Union[str, List[str]]) -> str:
    if isinstance(hash_base, str):
        return hash_base
    if isinstance(hash_base, list):
        if len(hash_base) == 1:
            return hash_base[0]
        return compute_hash(COMPOUND_SEPARATOR.join(hash_base))
    raise ValueError(
        f"Invalid base to compute composite hash: {type(hash_base)}: {hash_base}"
    )


def expression_hash(type_hash: str, elements: Sequence[str]) -> str:
    return composite_hash([type_hash, *elements])


class ExpressionHasher:
    """Namespace-compatible facade mirroring the reference class."""

    compound_separator = COMPOUND_SEPARATOR
    _compute_hash = staticmethod(compute_hash)
    named_type_hash = staticmethod(named_type_hash)
    terminal_hash = staticmethod(terminal_hash)
    composite_hash = staticmethod(composite_hash)
    expression_hash = staticmethod(expression_hash)


class StringExpressionHasher:
    """Debug variant producing READABLE handles instead of digests
    (reference expression_hasher.py:38-60: `<Concept: human>` — the handle
    style the reference StubDB exposes).  Never used on the device path."""

    @staticmethod
    def _compute_hash(text: str) -> str:
        return str(text)

    @staticmethod
    def named_type_hash(name: str) -> str:
        return f"<Type: {name}>"

    @staticmethod
    def terminal_hash(named_type: str, terminal_name: str) -> str:
        return f"<{named_type}: {terminal_name}>"

    @staticmethod
    def expression_hash(named_type_hash: str, elements: List[str]) -> str:
        return f"<{named_type_hash}: {elements}>"

    @staticmethod
    def composite_hash(hash_list: List[str]) -> str:
        if len(hash_list) == 1:
            return hash_list[0]
        return f"{hash_list}"


# ---------------------------------------------------------------------------
# Device handles: 64-bit truncation
# ---------------------------------------------------------------------------

def hex_to_i64(hex_digest: str) -> np.int64:
    """First 8 bytes of the digest as a signed big-endian int64.

    Two sentinel values are excluded from the real-key range so that no
    digest can collide with a table sentinel:

      * EMPTY_I64 (int64 min) — the "empty slot" marker — remaps to min+1;
      * int64 max — the capacity-pad marker used by the tensor store's
        padded buckets (storage/tensor_db.py) — remaps to max-1.
    """
    v = int(hex_digest[:16], 16)
    if v >= 2**63:
        v -= 2**64
    if v == int(EMPTY_I64):
        v += 1
    elif v == I64_PAD_MAX:
        v -= 1
    return np.int64(v)


def hex_to_i64_bulk(hex_digests) -> np.ndarray:
    """Vectorized `hex_to_i64` over a sequence of hex digests.

    Columnizing a multi-million-link bucket (storage/atom_table.py
    build_bucket) calls this once per bucket instead of the scalar
    function per link — the ASCII→nibble decode runs as 16 numpy vector
    ops.  Bit-exact with the scalar version incl. the sentinel remap."""
    m = len(hex_digests)
    if m == 0:
        return np.empty(0, dtype=np.int64)
    # dtype "S16" ascii-encodes and truncates each digest to its first 16
    # chars — exactly the 8 bytes the scalar version parses
    u = np.array(hex_digests, dtype="S16").view(np.uint8).reshape(m, 16)
    is_hex = (
        ((u >= 48) & (u <= 57)) | ((u >= 97) & (u <= 102)) | ((u >= 65) & (u <= 70))
    )
    if not is_hex.all():
        # non-hex char or a digest shorter than 16 chars (NUL padding from
        # the "S16" cast) — take the scalar path, which parses (or raises)
        # exactly like int(x, 16)
        return np.array([hex_to_i64(h) for h in hex_digests], dtype=np.int64)
    nib = np.where(
        u >= 97, u - 87, np.where(u >= 65, u - 55, u - 48)
    ).astype(np.uint64)
    val = np.zeros(m, dtype=np.uint64)
    for k in range(16):
        val = (val << np.uint64(4)) | nib[:, k]
    out = val.view(np.int64).copy()  # two's complement == the v-2**64 branch
    out[out == EMPTY_I64] += 1
    out[out == I64_PAD_MAX] -= 1
    return out


def i64_hash_str(text: str) -> np.int64:
    return hex_to_i64(compute_hash(text))


def hex_list_to_i64(hex_digests: Iterable[str]) -> np.ndarray:
    return np.array([hex_to_i64(h) for h in hex_digests], dtype=np.int64)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over uint64 views, wrapping mod 2^64 as
    numpy's uint64 arithmetic does."""
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return x
