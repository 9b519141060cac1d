"""The generators: deterministic from the seed, at the sizes the
configuration files state, written in the canonical format."""

import hashlib
import json

import numpy as np
import pytest

from dasbench import kb as kbmod
from dasbench import run

CONFIGS = [c["name"] for c in run.read_json(run.ROOT / "BENCHMARK.json")["configs"]]


def _generator(name):
    return run.load_path(run.HERE / "gen" / f"{name}.py", f"dasbench_gen_{name}")


def _config(name):
    return run.read_json(run.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_sizes_match_the_configuration(name):
    config = _config(name)
    kb = _generator(name).generate(config, 2**31 + 11)
    assert kb.counts() == (config["nodes"], config["links"])
    assert kb.nodes["Gene"].count == config["n_genes"]
    member = kb.pairs("Member", "Gene", "BiologicalProcess")
    assert len(member) == config["n_genes"] * config["members_per_gene"]
    assert len(np.unique(member, axis=0)) == len(member)
    inter = kb.pairs("Interacts", "Gene", "Gene")
    assert len(inter) == 2 * config["n_interactions"]
    assert (inter[:, 0] != inter[:, 1]).all()


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_is_deterministic_from_the_seed(name, tiny):
    config = dict(_config(name), **tiny)
    gen = _generator(name)
    a, b, c = gen.generate(config, 7), gen.generate(config, 7), gen.generate(config, 8)
    for x, y, z in zip(a.links, b.links, c.links):
        for cx, cy in zip(x.columns, y.columns):
            assert np.array_equal(cx, cy)
    assert any(not np.array_equal(x.columns[-1], z.columns[-1]) for x, z in zip(a.links, c.links))


def test_canonical_file_lines(tmp_path, tiny):
    name = CONFIGS[0]
    kb = _generator(name).generate(dict(_config(name), **tiny), 3)
    path = tmp_path / "kb.metta"
    n = kbmod.write_canonical(kb, str(path))
    lines = path.read_text().splitlines()
    assert n == sum(1 for line in lines if not line.startswith("(:"))
    # an Evaluation line holds two links: the Evaluation and its List
    assert kb.counts()[1] == n + sum(len(ls) for ls in kb.links if ls.wrap)
    assert '(: "GENE:0000010" Gene)' in lines
    assert any(line.startswith('(Evaluation "Predicate Predicate:has_name" (List "Gene GENE:')
               for line in lines)
    member = kb.pairs("Member", "Gene", "BiologicalProcess")[0]
    assert f'(Member "Gene GENE:{member[0]:07d}" "BiologicalProcess GO:{member[1]:07d}")' in lines
    assert kbmod.handle("Gene", "GENE:0000001") == hashlib.md5(b"Gene GENE:0000001").hexdigest()


def test_configuration_files_state_their_cut():
    """`reduced` names exactly the published numbers the file changes, and
    every size the source does not publish is listed as assumed."""
    bench = run.read_json(run.ROOT / "BENCHMARK.json")
    for entry in bench["configs"]:
        config = json.loads((run.ROOT / entry["file"]).read_text())
        assert entry["source"] == config["source"]
        changed = {k for k, v in config["published"].items() if config[k] != v}
        assert set(entry["reduced"]) == changed == set(config["reduced"]) - {"why", "limit"}
        sizes = {k for k, v in config.items() if k.startswith("n_") or k.endswith("_per_gene")}
        assert sizes <= set(config["assumed"]) | set(config["published"])
        assert config["guarantees"] and config["layout"]["chips"] == 1
