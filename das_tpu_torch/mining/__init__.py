"""The pattern miner (port of `das_tpu/mining/`)."""

from das_tpu_torch.mining.miner import MinedPattern, PatternMiner  # noqa: F401
