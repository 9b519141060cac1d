"""The `das` package's DistributedAtomSpace (reference
das/distributed_atom_space.py:26-414) over das_tpu_torch.

The reference connects to MongoDB and Redis through environment
variables; the port reads no environment.  `configure(backend=, device=,
checkpoint_path=)` sets, for the whole process, what a later
`DistributedAtomSpace()` builds: the store ("memory" | "tensor" |
"sharded"), its torch device (None = the CUDA card; the construction
raises without one) and a checkpoint directory loaded at construction in
place of the database servers.  Keyword arguments given to the
constructor win over the configured ones.  The reference's private
`_get_file_list`, which its own tests call, is kept under that name."""

from __future__ import annotations

from typing import List, Optional

from das_tpu_torch.api.atomspace import DistributedAtomSpace as _Facade
from das_tpu_torch.api.atomspace import QueryOutputFormat, Transaction  # noqa: F401
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.core.schema import WILDCARD  # noqa: F401  (reference :22 re-export)

#: what a bare construction builds: set only by configure()
_SETTINGS = {"backend": "tensor", "device": None, "checkpoint_path": None}


def configure(backend: str = "tensor", device: Optional[str] = None,
              checkpoint_path: Optional[str] = None) -> None:
    """Set the store that every later `DistributedAtomSpace()` of this
    process builds; a call replaces all three settings, and the defaults
    are a bare construction's (the tensor store on the CUDA card, no
    checkpoint)."""
    if backend not in ("memory", "tensor", "sharded"):
        raise ValueError(f"Unknown backend: {backend}")
    _SETTINGS.update(backend=backend, device=device, checkpoint_path=checkpoint_path)


class DistributedAtomSpace(_Facade):
    def __init__(self, **kwargs):
        if "config" not in kwargs:
            kwargs["config"] = DasConfig(backend=_SETTINGS["backend"],
                                         checkpoint_path=_SETTINGS["checkpoint_path"])
        kwargs.setdefault("device", _SETTINGS["device"])
        super().__init__(**kwargs)

    def _get_file_list(self, source: str) -> List[str]:
        """Knowledge-base path expansion (reference
        distributed_atom_space.py:81-99)."""
        from das_tpu_torch.ingest.pipeline import knowledge_base_file_list

        return knowledge_base_file_list(source)
