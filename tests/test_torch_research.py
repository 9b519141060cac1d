"""The research layer of the port (das_tpu_torch/research/: the keyed
min-heap, the size-bounded write-back cache, the incoming/outgoing-set
builder, and utils/timing.py) against the JAX package's copies (das_tpu,
host code only): the same operation sequences, drawn from a seed, leave the
same heap order, the same cache and backend contents and the same
eviction counts; the builder's key-value output is equal to das_tpu's and
to the finalized incoming CSR of the port's store."""

import random

import pytest

from das_tpu.models.animals import animals_metta as jx_animals
from das_tpu.research import cache as jx_cache
from das_tpu.research import heap as jx_heap
from das_tpu.research import incoming_builder as jx_builder
from das_tpu.storage.atom_table import load_metta_text as jx_load
from das_tpu_torch.models.animals import animals_metta
from das_tpu_torch.research import cache, heap, incoming_builder
from das_tpu_torch.storage.atom_table import load_metta_text
from das_tpu_torch.utils.timing import Clock, Statistics


def _heap_trace(mod, seed):
    rng = random.Random(seed)
    h, out = mod.Heap(), []
    for i in range(300):
        op = rng.random()
        if op < 0.6 or not len(h):
            h.heap_push(mod.PrioritizedItem(key=f"k{i}", size=rng.randrange(50), value=i))
        elif op < 0.8:
            item = h.heap_pop()
            out.append(("pop", item.key, item.size))
        elif op < 0.9:
            key = h[rng.randrange(len(h))].key
            out.append(("remove", h.remove_by_key(key).key))
        else:
            item = h[rng.randrange(len(h))]
            item.size += rng.randrange(1, 30)
            h.fix_down(item)
        out.append(tuple((x.key, x.size) for x in h))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heap_equals_das_tpu(seed):
    assert _heap_trace(heap, seed) == _heap_trace(jx_heap, seed)


def _cache_trace(mod, seed, limit):
    rng = random.Random(seed)
    fake = mod.FakeKVClient()
    cached = mod.CachedKVClient(fake, limit=limit)
    out = []
    for i in range(400):
        key = f"k{rng.randrange(40)}"
        if rng.random() < 0.6:
            value = [rng.randrange(9) for _ in range(rng.randrange(1, 8))]
            cached.add(key, value, size=len(value))
        else:
            try:
                out.append(("get", key, list(cached.get(key))))
            except mod.DocumentNotFoundException:
                out.append(("miss", key))
        out.append((cached.current_size, fake.total_add_calls))
    cached.flush()
    out.append(sorted((k, list(v)) for k, v in fake.d.items()))
    return out


@pytest.mark.parametrize("seed,limit", [(0, 6), (1, 20), (2, 64)])
def test_cache_equals_das_tpu(seed, limit):
    assert _cache_trace(cache, seed, limit) == _cache_trace(jx_cache, seed, limit)


def test_incoming_builder_equals_das_tpu_and_csr():
    data = load_metta_text(animals_metta())
    fake, jfake = cache.FakeKVClient(), jx_cache.FakeKVClient()
    stats = incoming_builder.populate_sets(data, fake, cache_limit=16)
    jstats = jx_builder.populate_sets(jx_load(jx_animals()), jfake, cache_limit=16)
    assert fake.d == jfake.d and fake.total_add_calls == jfake.total_add_calls
    for name in ("incoming_size", "outgoing_size"):
        assert stats[name].samples == jstats[name].samples
    fin = data.finalize()
    for row, handle in enumerate(fin.hex_of_row):
        lo, hi = fin.incoming_offsets[row], fin.incoming_offsets[row + 1]
        expected = sorted({fin.hex_of_row[r] for r in fin.incoming_links[lo:hi]})
        assert incoming_builder.read_sets(fake, handle) == jx_builder.read_sets(jfake, handle)
        assert incoming_builder.read_sets(fake, handle)[1] == expected


def test_timing():
    s = Statistics()
    for v in (3.0, 1.0, 2.0, 4.0):
        s.add(v)
    assert (s.mean(), s.median(), s.percentile(0), s.percentile(100)) == (2.5, 2.5, 1.0, 4.0)
    assert Statistics().mean() == 0.0 and Statistics().percentile(50) == 0.0
    assert round(s.stdev(), 6) == 1.290994
    assert Clock().elapsed() >= 0.0
