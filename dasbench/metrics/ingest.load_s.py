"""ingest.load_s: `load_canonical_knowledge_base` of the set-up's KB file,
ended by `torch.cuda.synchronize()` (host clock)."""


def read(run):
    return run.setup["load_s"]
