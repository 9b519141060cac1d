"""Seed a checkpoint directory with the animals knowledge base, once
(port of `das_tpu/service/seed_checkpoint.py`).

The directory gets the port's generational layout (storage/durable.py:
`gen-000001/` with a CRC-digest manifest and JSON payloads), so a service
whose tenants are configured with `DasConfig(snapshot_dir=...)` or
`checkpoint_path=...` answers count == (14, 26) with no load RPC.  A seed
already there, in either layout, is left as it is.

    python -m das_tpu_torch.service.seed_checkpoint /path/to/kb [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def seed(path: str, device=None) -> None:
    from das_tpu_torch.core.config import DasConfig
    from das_tpu_torch.models.animals import animals_metta
    from das_tpu_torch.storage import checkpoint, durable
    from das_tpu_torch.storage.atom_table import load_metta_text
    from das_tpu_torch.storage.tensor_db import TensorDB

    if os.path.exists(os.path.join(path, checkpoint.RECORDS_FILE)):
        print(f"checkpoint already present at {path} (flat layout)")
        return
    if durable.list_generations(path):
        print(f"checkpoint already present at {path} (generational)")
        return
    data = load_metta_text(animals_metta())
    db = TensorDB(data, DasConfig(), device=device)
    gen_dir = durable.write_snapshot(db, path)
    nodes, links = data.count_atoms()
    print(f"seeded {gen_dir}: {nodes} nodes / {links} links")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args()
    seed(args.path, device=args.device)
