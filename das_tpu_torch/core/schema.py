"""Shared constants and naming schema.

Mirrors the semantic constants of the reference
(reference das/database/db_interface.py:4-5,
 reference das/database/mongo_schema.py:3-18,
 reference das/database/key_value_schema.py:3-11) without the
Mongo/Redis specifics: in the TPU build these names survive only as logical
field names of the columnar store and checkpoint layout.
"""

WILDCARD = "*"

# Link types whose targets form a multiset rather than a tuple.  Targets of
# unordered links are canonically sorted at ingest (as the reference does in
# redis_mongo_db.py:249-250) so any permutation hashes identically.
UNORDERED_LINK_TYPES = ["Similarity", "Set"]

TYPEDEF_MARK = ":"
BASIC_TYPE = "Type"


class AtomKinds:
    NODE = 0
    LINK = 1
    TYPEDEF = 2


class TableNames:
    """Logical table names of the columnar store (checkpoint keys)."""

    NODES = "nodes"
    ATOM_TYPES = "atom_types"
    LINKS = "links"            # bucketed by arity: links/arity_{a}
    OUTGOING = "outgoing_set"
    INCOMING = "incoming_set"
    PATTERNS = "patterns"
    TEMPLATES = "templates"
    NAMES = "names"


class FieldNames:
    ID_HASH = "_id"
    TYPE = "composite_type_hash"
    TYPE_NAME = "named_type"
    TYPE_NAME_HASH = "named_type_hash"
    COMPOSITE_TYPE = "composite_type"
    NODE_NAME = "name"
    KEY_PREFIX = "key"
    KEYS = "keys"
