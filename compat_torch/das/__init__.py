"""The `das` package of the upstream Distributed Atom Space, over the
PyTorch port (das_tpu_torch): with `PYTHONPATH=compat_torch:.` the
reference's own scripts and notebooks import `das` and run on the port's
stores, the card's kernels included.

Module map (reference file -> source):
  das/distributed_atom_space.py  -> das_tpu_torch.api.atomspace, plus
                                    `configure` (below)
  das/database/db_interface.py   -> das_tpu_torch.storage.interface and
                                    core.schema
  das/database/stub_db.py        -> the reference's fixture over
                                    das_tpu_torch's MemoryDB, with readable
                                    handles
  das/pattern_matcher/pattern_matcher.py
                                 -> das_tpu_torch.query.ast and
                                    query.assignment; the expression classes'
                                    `matched(db, answer)` goes through the
                                    port's router (query/compiler.py
                                    dispatch), so the reference's
                                    `expr.matched(das.db, answer)` call
                                    sites reach the device path
  das/expression_hasher.py       -> das_tpu_torch.core.hashing
  das/expression.py              -> das_tpu_torch.core.expression
  das/transaction.py             -> das_tpu_torch.api.atomspace.Transaction
  das/exceptions.py              -> das_tpu_torch.core.exceptions
  das/logger.py                  -> the "das_tpu_torch" logger

The reference picks its databases from environment variables; the port
reads none.  `das.configure(backend=, device=, checkpoint_path=)` sets
what a later `DistributedAtomSpace()` builds, process-wide:

    import das
    das.configure(backend="tensor", device="cpu")   # default: the CUDA card

A bare `DistributedAtomSpace()` with nothing configured builds the tensor
store on the CUDA card and raises without one.
"""

from das.distributed_atom_space import configure  # noqa: F401
