#!/usr/bin/env python
"""Store export and import in the reference's mongoexport text format, on
the PyTorch port (the counterpart of scripts/dump_das.py).

    # export a checkpoint (or a .metta file) to <prefix>.{nodes,atom_types,links_*}
    python scripts/dump_das_torch.py dump --checkpoint /path/ckpt /tmp/out/animals
    python scripts/dump_das_torch.py dump --metta data/samples/animals.metta /tmp/out/animals

    # import a dump back into a checkpoint
    python scripts/dump_das_torch.py load /tmp/out/animals --checkpoint-out /path/ckpt2

Both directions work on the host tables (`AtomSpaceData`) alone and build
no store, so neither takes a device.  The files are those
das_tpu_torch/convert/dump.py writes, byte-identical to
scripts/dump_das.py's for the same KB.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    d = sub.add_parser("dump", help="export a store to <prefix>.<collection> files")
    src = d.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="checkpoint directory to export")
    src.add_argument("--metta", help=".metta file/dir to load and export")
    d.add_argument("prefix", help="output file prefix")
    d.add_argument("--include-empty", action="store_true",
                   help="also write empty collection files")
    ld = sub.add_parser("load", help="import a dump into a checkpoint")
    ld.add_argument("prefix", help="dump file prefix")
    ld.add_argument("--checkpoint-out", required=True)
    args = ap.parse_args(argv)

    from das_tpu_torch.convert import dump as dump_mod
    from das_tpu_torch.storage import checkpoint

    if args.command == "dump":
        if args.checkpoint:
            data = checkpoint.load(args.checkpoint)
        else:
            from das_tpu_torch.ingest.pipeline import load_knowledge_base
            from das_tpu_torch.storage.atom_table import AtomSpaceData

            data = load_knowledge_base(AtomSpaceData(), args.metta)
        os.makedirs(os.path.dirname(os.path.abspath(args.prefix)), exist_ok=True)
        written = dump_mod.dump_store(data, args.prefix, include_empty=args.include_empty)
        nodes, links = data.count_atoms()
        print(f"dumped {nodes} nodes, {links} links -> {', '.join(written)}")
    else:
        data = dump_mod.load_dump(args.prefix)
        checkpoint.save(data, args.checkpoint_out, with_indexes=True)
        nodes, links = data.count_atoms()
        print(f"loaded {nodes} nodes, {links} links -> {args.checkpoint_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
