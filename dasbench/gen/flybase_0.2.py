"""Generator of the `flybase_0.2` configuration: the FlyBase-shaped KB
(dasbench/bio.py `flybase`) at the sizes of configs/flybase_0.2.json."""

from dasbench import bio


def generate(config: dict, seed: int):
    return bio.flybase(config, seed)
